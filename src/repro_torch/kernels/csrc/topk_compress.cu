// Exact per-row magnitude top-k for Hopper (sm_90a): the sparse reducer's
// compress step (repro_torch/comm/sparse.py).
//
// Replaces the Pallas TPU kernel repro/kernels/topk_compress.py::topk_compress
// (bodies _threshold_select, _topk_kernel_scan, _topk_kernel_onehot) and
// computes exactly what repro/kernels/ref.py::topk_compress_ref computes:
// lax.top_k(|x as fp32|, k) with ties at the k-th magnitude going to the
// lowest indices, the k indices then sorted ascending and the values
// gathered from x.  x is [rows, n] fp32 or bf16; out vals [rows, k] in x's
// type (bits copied, subnormals and -0.0 included), idx [rows, k] int32.
//
// Design (simple and right first).  Rows are few (16 learners) and long
// (up to 2.4 M elements per leaf), so every pass runs a grid of
// (chunks of CHUNK elements) x (rows) CTAs instead of the Pallas kernel's
// one program per row, which would leave most of the 132 SMs idle.
//   * Key: the fp32 bit pattern of |x| (bf16 widened first), a 31-bit
//     integer whose order is the magnitude order.
//   * Radix select of the exact k-th largest key t, 7 + 8 + 8 + 8 bits from
//     the top: per digit, each CTA builds a shared-memory histogram of the
//     keys that match the digits fixed so far and adds it into a per-row
//     histogram in device memory (integer adds: their order never reaches
//     the output); one CTA per row then walks that histogram from the top,
//     fixes the digit and lowers the remaining count.  After four digits t
//     is the k-th key, and fill = k - #(key > t) is how many of the keys
//     equal to t are taken (the lowest-indexed ones).
//   * Count: per chunk, gt = #(key > t) and eq = #(key == t).
//   * Scan: per row, exclusive scans over chunks of eq and of
//     kept = gt + clamp(fill - eq_before, 0, eq).
//   * Compact: each CTA re-reads its chunk in index order, tile by tile,
//     ranks its kept elements with a block scan and writes x[i] and i at
//     kept_before + rank.  Only the one chunk where the taken ties end
//     ranks its ties as well.
// Deterministic: no sort, and no float atomics; every output slot follows
// from integer counts.  Offsets of row * n are 64-bit.
//
// Bound: bytes.  The call must read rows * n elements once and write
// rows * k * (element + 4) bytes; it does a few integer operations per
// element.  For one global fire of ResNet-18 at width 64 with 16 learners
// (55 leaves, 11,172,160 fp32 parameters each) that is 715 MB read and
// 71 MB written, 0.235 ms at 3.35 TB/s over 55 launches.  This design
// reads x six times (four histogram passes, count, compact) and launches
// twelve kernels per call, so it sits several times above the bound;
// fewer passes (a wider first digit, the count folded into the last
// histogram), one launch for all leaves of a fire, and CUDA graphs are
// later work.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/topk_compress.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;              // per CTA of the chunk passes
constexpr int ITEMS = 4;                  // consecutive elements per thread per tile
constexpr int TILE = THREADS * ITEMS;     // 1024 elements
constexpr int CHUNK = 8 * TILE;           // 8192 elements per CTA
constexpr int BINS = 256;
constexpr int PASSES = 4;                 // digits of 7, 8, 8, 8 bits
constexpr int SCAN_THREADS = 1024;        // per row in the chunk scan
constexpr int NCOUNT = 4;                 // per chunk: gt, eq, eq_before, kept_before

// |x| as the fp32 bit pattern (T holds the bits of an fp32 or a bf16; a
// bf16 is the top half of an fp32)
template <typename T>
__device__ __forceinline__ uint32_t key_of(uint32_t raw) {
  return (sizeof(T) == 2 ? (raw << 16) : raw) & 0x7fffffffu;
}

template <typename T>
__device__ __forceinline__ uint32_t load_raw(const T* p) {
  return static_cast<uint32_t>(*p);
}

// Exclusive scan of one int per thread over the CTA; *total gets the sum.
// Every thread of the CTA must call it.  sh holds 32 ints.
__device__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();                        // the previous call's reads of sh are done
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) sh[lane] = s;      // inclusive warp prefixes
  }
  __syncthreads();
  *total = sh[nwarps - 1];
  return (warp ? sh[warp - 1] : 0) + x - v;
}

__device__ int block_sum(int v, int* sh) {
  int total;
  block_exclusive_scan(v, sh, &total);
  return total;
}

// One digit of the radix select: histogram of the keys that match the
// digits fixed so far.  grid (chunks, rows).
template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_hist(const T* __restrict__ x, int64_t n, int pass,
            const int* __restrict__ state, int* __restrict__ hist) {
  __shared__ int sh[BINS];
  const int row = blockIdx.y;
  for (int b = threadIdx.x; b < BINS; b += THREADS) sh[b] = 0;
  __syncthreads();
  const int shift = 24 - 8 * pass;
  // the bits above the current digit must match the digits fixed so far
  const uint32_t above = pass ? (0xffffffffu << (shift + 8)) : 0u;
  const uint32_t prefix = pass ? static_cast<uint32_t>(state[2 * row]) : 0u;
  const T* xr = x + static_cast<int64_t>(row) * n;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * CHUNK;
  const int64_t end = min(begin + CHUNK, n);
  for (int64_t base = begin; base < end; base += TILE) {
    uint32_t raw[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {     // all loads in flight first
      const int64_t i = base + j * THREADS + threadIdx.x;
      raw[j] = i < end ? load_raw(xr + i) : 0u;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t i = base + j * THREADS + threadIdx.x;
      const uint32_t key = key_of<T>(raw[j]);
      if (i < end && (key & above) == (prefix & above))
        atomicAdd(&sh[(key >> shift) & 0xffu], 1);
    }
  }
  __syncthreads();
  int* hr = hist + static_cast<int64_t>(row) * BINS;
  for (int b = threadIdx.x; b < BINS; b += THREADS) {
    const int c = sh[b];
    if (c) atomicAdd(&hr[b], c);
  }
}

// Fix one digit per row: walk the row's histogram from the top until the
// remaining count is reached.  state[row] = {prefix so far, count left}.
__global__ void topk_select(const int* __restrict__ hist, int pass, int k,
                              int* __restrict__ state) {
  __shared__ int sh[BINS];
  const int row = blockIdx.x;
  for (int b = threadIdx.x; b < BINS; b += blockDim.x)
    sh[b] = hist[static_cast<int64_t>(row) * BINS + b];
  __syncthreads();
  if (threadIdx.x != 0) return;
  const int shift = 24 - 8 * pass;
  const uint32_t prefix = pass ? static_cast<uint32_t>(state[2 * row]) : 0u;
  const int left = pass ? state[2 * row + 1] : k;
  int above = 0, digit = 0;
  for (int b = BINS - 1; b >= 0; --b) {
    const int c = sh[b];
    if (above + c >= left) { digit = b; break; }
    above += c;
  }
  state[2 * row] = static_cast<int>(prefix | (static_cast<uint32_t>(digit) << shift));
  state[2 * row + 1] = left - above;
}

// Per chunk: how many keys lie above the k-th key t, and how many equal it.
template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_count(const T* __restrict__ x, int64_t n, int nchunks,
             const int* __restrict__ state, int* __restrict__ counts) {
  __shared__ int sh[32];
  const int row = blockIdx.y;
  const uint32_t t = static_cast<uint32_t>(state[2 * row]);
  const T* xr = x + static_cast<int64_t>(row) * n;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * CHUNK;
  const int64_t end = min(begin + CHUNK, n);
  int gt = 0, eq = 0;
  for (int64_t base = begin; base < end; base += TILE) {
    uint32_t raw[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t i = base + j * THREADS + threadIdx.x;
      raw[j] = i < end ? load_raw(xr + i) : 0u;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int64_t i = base + j * THREADS + threadIdx.x;
      const uint32_t key = key_of<T>(raw[j]);
      gt += (i < end && key > t);
      eq += (i < end && key == t);
    }
  }
  gt = block_sum(gt, sh);
  eq = block_sum(eq, sh);
  if (threadIdx.x == 0) {
    int* c = counts + (static_cast<int64_t>(row) * nchunks + blockIdx.x) * NCOUNT;
    c[0] = gt;
    c[1] = eq;
  }
}

// Per row: where each chunk's kept elements start, and how many ties lie
// in the chunks before it.  One CTA per row.
__global__ void __launch_bounds__(SCAN_THREADS)
topk_scan(int nchunks, const int* __restrict__ state, int* __restrict__ counts) {
  __shared__ int sh[32];
  const int row = blockIdx.x;
  const int fill = state[2 * row + 1];
  int* cr = counts + static_cast<int64_t>(row) * nchunks * NCOUNT;
  int eq_carry = 0, kept_carry = 0;
  for (int base = 0; base < nchunks; base += SCAN_THREADS) {
    const int c = base + threadIdx.x;
    const int gt = c < nchunks ? cr[c * NCOUNT + 0] : 0;
    const int eq = c < nchunks ? cr[c * NCOUNT + 1] : 0;
    int eq_total, kept_total;
    const int eq_before = eq_carry + block_exclusive_scan(eq, sh, &eq_total);
    const int kept = gt + min(max(fill - eq_before, 0), eq);
    const int kept_before = kept_carry + block_exclusive_scan(kept, sh, &kept_total);
    if (c < nchunks) {
      cr[c * NCOUNT + 2] = eq_before;
      cr[c * NCOUNT + 3] = kept_before;
    }
    eq_carry += eq_total;
    kept_carry += kept_total;
  }
}

// Write each chunk's kept elements, in index order, at their slots.
template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_compact(const T* __restrict__ x, int64_t n, int k, int nchunks,
               const int* __restrict__ state, const int* __restrict__ counts,
               T* __restrict__ vals, int* __restrict__ idx) {
  __shared__ __align__(16) uint32_t tile[TILE];
  __shared__ int sh[32];
  const int row = blockIdx.y;
  const uint32_t t = static_cast<uint32_t>(state[2 * row]);
  const int fill = state[2 * row + 1];
  const int* c = counts + (static_cast<int64_t>(row) * nchunks + blockIdx.x) * NCOUNT;
  const int gt_c = c[0], eq_c = c[1], eq_before = c[2];
  int kept_run = c[3];
  if (gt_c + min(max(fill - eq_before, 0), eq_c) == 0) return;   // uniform over the CTA
  // only the chunk where the taken ties run out ranks its ties
  const bool partial = eq_before < fill && eq_before + eq_c > fill;
  const bool all_ties = eq_before + eq_c <= fill;
  int eq_run = eq_before;
  const T* xr = x + static_cast<int64_t>(row) * n;
  T* vr = vals + static_cast<int64_t>(row) * k;
  int* ir = idx + static_cast<int64_t>(row) * k;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * CHUNK;
  const int64_t end = min(begin + CHUNK, n);
  for (int64_t base = begin; base < end; base += TILE) {
    __syncthreads();                      // the previous tile's reads are done
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {     // coalesced loads, in index order
      const int64_t i = base + j * THREADS + threadIdx.x;
      tile[j * THREADS + threadIdx.x] = i < end ? load_raw(xr + i) : 0u;
    }
    __syncthreads();
    const uint4 q = reinterpret_cast<const uint4*>(tile)[threadIdx.x];
    const uint32_t raw[ITEMS] = {q.x, q.y, q.z, q.w};
    const int64_t first = base + static_cast<int64_t>(threadIdx.x) * ITEMS;
    bool is_gt[ITEMS], is_eq[ITEMS], keep[ITEMS];
    int n_eq = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const uint32_t key = key_of<T>(raw[j]);
      const bool valid = first + j < end;
      is_gt[j] = valid && key > t;
      is_eq[j] = valid && key == t;
      n_eq += is_eq[j];
    }
    if (partial) {
      int eq_total;
      int r = eq_run + block_exclusive_scan(n_eq, sh, &eq_total);
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        keep[j] = is_gt[j] || (is_eq[j] && r < fill);
        r += is_eq[j];
      }
      eq_run += eq_total;
    } else {
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) keep[j] = is_gt[j] || (is_eq[j] && all_ties);
    }
    int n_keep = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) n_keep += keep[j];
    int keep_total;
    int slot = kept_run + block_exclusive_scan(n_keep, sh, &keep_total);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (keep[j] && slot < k) {
        vr[slot] = static_cast<T>(raw[j]);
        ir[slot] = static_cast<int>(first + j);
      }
      slot += keep[j];
    }
    kept_run += keep_total;
  }
}

template <typename T>
cudaError_t launch(const T* x, T* vals, int* idx, int* scratch, int rows,
                   int64_t n, int k, cudaStream_t s) {
  const int nchunks = static_cast<int>((n + CHUNK - 1) / CHUNK);
  int* hist = scratch;                                    // [PASSES, rows, BINS], zeroed
  int* state = hist + static_cast<int64_t>(PASSES) * rows * BINS;   // [rows, 2]
  int* counts = state + 2 * rows;                          // [rows, nchunks, NCOUNT]
  const dim3 grid(nchunks, rows);
  cudaError_t err;
  for (int p = 0; p < PASSES; ++p) {
    int* hp = hist + static_cast<int64_t>(p) * rows * BINS;
    topk_hist<T><<<grid, THREADS, 0, s>>>(x, n, p, state, hp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    topk_select<<<rows, BINS, 0, s>>>(hp, p, k, state);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  topk_count<T><<<grid, THREADS, 0, s>>>(x, n, nchunks, state, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_scan<<<rows, SCAN_THREADS, 0, s>>>(nchunks, state, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_compact<T><<<grid, THREADS, 0, s>>>(x, n, k, nchunks, state, counts,
                                             vals, idx);
  return cudaGetLastError();
}

}  // namespace

// Ints of zeroed scratch a call needs: the per-pass histograms, the per-row
// select state and the per-chunk counts.
extern "C" long long topk_compress_scratch_ints(int rows, long long n) {
  const long long nchunks = (n + CHUNK - 1) / CHUNK;
  return static_cast<long long>(rows) * (PASSES * BINS + 2 + nchunks * NCOUNT);
}

// dtype codes: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches (cudaGetLastError after each); 0 means all were accepted.
// Refuses rows < 1, n < 1, n >= 2^31 and k outside [1, n] with
// cudaErrorInvalidValue.
extern "C" int topk_compress_launch(const void* x, void* vals, void* idx, void* scratch,
                                    int dtype, int rows, long long n, int k, int device,
                                    void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows < 1 || rows > 65535 || n < 1 || n >= (1LL << 31) || k < 1 || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* sc = static_cast<int*>(scratch);
  int* id = static_cast<int*>(idx);
  if (dtype == 0)
    err = launch<uint32_t>(static_cast<const uint32_t*>(x), static_cast<uint32_t*>(vals), id,
                           sc, rows, n, k, s);
  else if (dtype == 1)
    err = launch<uint16_t>(static_cast<const uint16_t*>(x), static_cast<uint16_t*>(vals), id,
                           sc, rows, n, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
