// Batched thin-QR (Q factor) of tall-skinny panels for Hopper (sm_90a):
// PowerSGD's orthonormalization (repro_torch/comm/lowrank.py).
//
// Replaces the Pallas TPU kernel repro/kernels/batched_qr.py::batched_qr
// (body _qr_kernel) and computes its recurrence, classical Gram-Schmidt
// with reorthogonalization (CGS2), in fp32:
//
//   p [batch, a, r] fp32, a >= r; for each panel and column j = 0 .. r-1:
//     v = p[:, j]
//     twice:  c = Q[:, :j]^T v ;  v = v - Q[:, :j] c
//     Q[:, j] = |v|^2 > 1e-30 ? v * rsqrt(|v|^2) : 0
//
// so a rank-deficient column comes out as an exact zero column and each
// column keeps the input panel's sign.  The plain version is
// repro_torch/kernels/ref.py::batched_qr_plain (torch.rsqrt where this uses
// rsqrtf, and sums in another order: equal within a tolerance, not in bits).
//
// Design (simple and right first).  One CTA of 256 threads per panel (the
// flattened [pods * G * S] learner row).  Thread t owns rows t, t + 256, ...
// of the panel for the whole call, so the only communication is the
// block-wide sums (the r coefficients of a projection pass, then the
// squared norm), by warp shuffles and one shared-memory pass.  The panel
// lives in shared memory when a * r * 4 bytes fit in 48 KiB (1536 x 8 x 4
// bytes is exactly 48 KiB, the largest panel of the trainer's PowerSGD
// levels; with the reduction buffers beside it the launch opts in to more
// than the default 48 KiB); a larger panel is worked in place in the
// output, in device memory, which only its owning thread ever touches.
// a need not be a multiple of anything; r is at most 32 (rank <= 8 takes a
// leaner build).
//
// Bound: launch latency.  At the trainer's shapes ([16, 1536, 2] per
// bucket on the uniform matrix layout) a launch is 16 CTAs on 132 SMs and
// moves 0.4 MB, about 0.12 us of HBM time: the launch dominates.  Batching
// every bucket of a fire into one launch is later perf_opt work.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/batched_qr.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float EPS = 1e-30f;
constexpr int SMEM_LIMIT = 48 * 1024;

// Block-wide sums of vals[0 .. cnt-1] (cnt <= R); every thread gets them.
// red holds WARPS * R floats, out R floats.
template <int R>
__device__ void block_sums(float (&vals)[R], int cnt, float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (k < cnt) {
      float v = vals[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if (lane == 0) red[warp * R + k] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < cnt) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w * R + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k)
    if (k < cnt) vals[k] = out[k];
  __syncthreads();                         // red/out are free for the next call
}

// S: the panel being orthonormalized, [a, r] row-major (shared memory or
// the output itself).  Thread t touches only rows t, t + THREADS, ...
template <int R>
__device__ void cgs2(const float* __restrict__ x, float* S, int a, int r,
                     float* red, float* out) {
  for (int j = 0; j < r; ++j) {
    for (int i = threadIdx.x; i < a; i += THREADS) S[i * r + j] = x[i * r + j];
    for (int pass = 0; pass < 2; ++pass) {
      float c[R];
#pragma unroll
      for (int k = 0; k < R; ++k) c[k] = 0.0f;
      for (int i = threadIdx.x; i < a; i += THREADS) {
        const float v = S[i * r + j];
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (k < j) c[k] += S[i * r + k] * v;
      }
      block_sums<R>(c, j, red, out);
      for (int i = threadIdx.x; i < a; i += THREADS) {
        float s = 0.0f;
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (k < j) s += S[i * r + k] * c[k];
        S[i * r + j] -= s;
      }
    }
    float nrm[R];
#pragma unroll
    for (int k = 0; k < R; ++k) nrm[k] = 0.0f;
    for (int i = threadIdx.x; i < a; i += THREADS) {
      const float v = S[i * r + j];
      nrm[0] += v * v;
    }
    block_sums<R>(nrm, 1, red, out);
    const float inv = nrm[0] > EPS ? rsqrtf(nrm[0]) : 0.0f;
    for (int i = threadIdx.x; i < a; i += THREADS) S[i * r + j] *= inv;
  }
}

template <int R, bool SMEM>
__global__ void __launch_bounds__(THREADS)
batched_qr_kernel(const float* __restrict__ p, float* __restrict__ q, int a, int r) {
  extern __shared__ float panel[];
  __shared__ float red[WARPS * R];
  __shared__ float out[R];
  const int64_t off = static_cast<int64_t>(blockIdx.x) * a * r;
  const float* x = p + off;
  float* dst = q + off;
  if (SMEM) {
    cgs2<R>(x, panel, a, r, red, out);
    for (int i = threadIdx.x; i < a; i += THREADS)
      for (int k = 0; k < r; ++k) dst[i * r + k] = panel[i * r + k];
  } else {
    cgs2<R>(x, dst, a, r, red, out);
  }
}

template <int R>
cudaError_t launch(const float* p, float* q, int batch, int a, int r, cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(a) * r * sizeof(float);
  if (bytes <= SMEM_LIMIT) {
    // the panel plus the static reduction buffers pass the 48 KiB a launch
    // gets by default at 1536 x 8: opt in to the panel's dynamic size
    cudaError_t err = cudaFuncSetAttribute(batched_qr_kernel<R, true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    batched_qr_kernel<R, true><<<batch, THREADS, bytes, s>>>(p, q, a, r);
  } else {
    batched_qr_kernel<R, false><<<batch, THREADS, 0, s>>>(p, q, a, r);
  }
  return cudaGetLastError();
}

}  // namespace

// p, q [batch, a, r] fp32 contiguous, 1 <= r <= min(a, 32).  Returns the
// cudaError_t of the launch (0 = accepted); refuses other shapes with
// cudaErrorInvalidValue.
extern "C" int batched_qr_launch(const void* p, void* q, int batch, int a, int r, int device,
                                 void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch < 1 || r < 1 || r > 32 || a < r) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(p);
  float* qq = static_cast<float*>(q);
  err = r <= 8 ? launch<8>(pp, qq, batch, a, r, s) : launch<32>(pp, qq, batch, a, r, s);
  return static_cast<int>(err);
}
