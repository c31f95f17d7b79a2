// Fused per-block int8 quantize + pack, and its inverse, for Hopper
// (sm_90a): the qint8 codec's compress and decompress steps
// (repro_torch/comm/quant.py).
//
// Replaces the Pallas TPU kernels repro/kernels/qint8_pack.py::qint8_pack
// (body _pack_kernel) and ::qint8_unpack (body _unpack_kernel) and computes
// exactly what repro/kernels/ref.py::qint8_pack_ref / qint8_unpack_ref
// compute under jit:
//
//   x [rows, n] fp32 or bf16, split per row into nb = ceil(n / block)
//   blocks of `block` elements, the last one zero-padded;
//   scale = max(max|x_block| * fp32(1/127), 1e-12)      (fp32)
//   q     = clip(rint(x / scale), -127, 127)             (IEEE division,
//                                                         half to even)
//   wire [rows, nb, block + 4] int8: q, then the 4 bytes of scale
//   (little-endian, the bitcast of the reference)
//   unpack: out [rows, n] fp32 = q * scale, padding never written.
//
// XLA folds the reference's `max|x| / 127.0` into a multiply by the fp32
// reciprocal of 127; the kernel multiplies by that same constant, so its
// scales equal the reference's bit for bit.  Built without fast math: the
// division x / scale is IEEE and rintf rounds half to even.
//
// Scope: finite inputs, as in both references.  A NaN is outside the
// contract: jnp.max propagates it into the block's scale, while fmaxf here
// drops it.
//
// Design (simple and right first).  The work is memory-bound: the pack reads
// 4 bytes and writes ~1 byte per element.  The Pallas grid runs one program
// per row, which on this card would leave most of the 132 SMs idle with 16
// rows, so here one warp owns one block (rows * nb warps, 8 per CTA):
//   * pass 1: each lane takes elements lane, lane + 32, ... of the block,
//     a warp max of |x| gives the scale;
//   * pass 2: the warp re-reads the block (from L1/L2: it just read it) and
//     writes the int8 payload.  When block % 4 == 0 every block's wire
//     record starts on a 4-byte boundary, so each lane quantizes 4
//     consecutive elements and stores them as one 32-bit word, and the scale
//     is one 32-bit store; otherwise (block 255, say) the payload and the
//     tail are stored byte by byte, since the row pitch block + 4 is then not
//     4-byte aligned.
//   * unpack: one warp per block, the scale read from the tail (as a word
//     when aligned, else as 4 bytes), q * scale written straight into
//     [rows, n] for the columns below n: no padded copy, no slice.
// Offsets are 64-bit.
//
// Bound: bytes.  A pack reads rows * n * 4 bytes (fp32) and writes
// rows * nb * (block + 4); an unpack moves the same bytes the other way.
// For one local fire of ResNet-18 at width 64 with 16 learners on the
// uniform bucket layout (10 buckets of [16, 2,359,296] fp32, block 256)
// that is 1.51 GB read and 0.38 GB written per pack pass: 0.565 ms at
// 3.35 TB/s.  Reading the block twice costs L1/L2 traffic, not HBM; the
// byte stores and one-warp-per-256-elements grid are what a later perf_opt
// PR should look at first.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/qint8_pack.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                  // blocks (warps) per CTA
constexpr int THREADS = WARPS * 32;
constexpr float INV_127 = 0.007874015718698502f;   // fp32(1/127)
constexpr float SCALE_FLOOR = 1e-12f;

// The value of element `col` of a row as fp32 (T holds the bits of an fp32
// or a bf16; a bf16 is the top half of an fp32).  Columns past n read 0.
template <typename T>
__device__ __forceinline__ float load_val(const T* row, int64_t col, int64_t n) {
  if (col >= n) return 0.0f;
  uint32_t raw = static_cast<uint32_t>(row[col]);
  return __uint_as_float(sizeof(T) == 2 ? (raw << 16) : raw);
}

__device__ __forceinline__ int quantize(float v, float scale) {
  float q = rintf(v / scale);             // IEEE division, half to even
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int>(q);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
qint8_pack_kernel(const T* __restrict__ x, int8_t* __restrict__ wire,
                  int64_t n_blocks, int64_t nb, int64_t n, int block) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (b >= n_blocks) return;                // whole warps exit together
  const int64_t row = b / nb, blk = b - row * nb;
  const T* xr = x + row * n;
  const int64_t col0 = blk * block;
  const int64_t pitch = block + 4;
  int8_t* out = wire + b * pitch;

  float amax = 0.0f;
  for (int e = lane; e < block; e += 32)
    amax = fmaxf(amax, fabsf(load_val(xr, col0 + e, n)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = fmaxf(amax * INV_127, SCALE_FLOOR);

  if ((block & 3) == 0) {
    uint32_t* out_w = reinterpret_cast<uint32_t*>(out);
    const int words = block >> 2;
    for (int w = lane; w < words; w += 32) {
      const int64_t c = col0 + 4 * static_cast<int64_t>(w);
      uint32_t packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = quantize(load_val(xr, c + j, n), scale);
        packed |= (static_cast<uint32_t>(q) & 0xffu) << (8 * j);
      }
      out_w[w] = packed;
    }
    if (lane == 0) out_w[words] = __float_as_uint(scale);
  } else {
    for (int e = lane; e < block; e += 32)
      out[e] = static_cast<int8_t>(quantize(load_val(xr, col0 + e, n), scale));
    if (lane < 4)
      out[block + lane] = static_cast<int8_t>((__float_as_uint(scale) >> (8 * lane)) & 0xffu);
  }
}

__global__ void __launch_bounds__(THREADS)
qint8_unpack_kernel(const int8_t* __restrict__ wire, float* __restrict__ out,
                    int64_t n_blocks, int64_t nb, int64_t n, int block) {
  const int lane = threadIdx.x & 31;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (b >= n_blocks) return;
  const int64_t row = b / nb, blk = b - row * nb;
  const int64_t col0 = blk * block;
  const int64_t pitch = block + 4;
  const int8_t* in = wire + b * pitch;
  float* orow = out + row * n;

  if ((block & 3) == 0) {
    const uint32_t* in_w = reinterpret_cast<const uint32_t*>(in);
    const int words = block >> 2;
    const float scale = __uint_as_float(in_w[words]);
    for (int w = lane; w < words; w += 32) {
      const uint32_t packed = in_w[w];
      const int64_t c = col0 + 4 * static_cast<int64_t>(w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c + j < n) {
          const int8_t q = static_cast<int8_t>((packed >> (8 * j)) & 0xffu);
          orow[c + j] = static_cast<float>(q) * scale;
        }
      }
    }
  } else {
    uint32_t bits = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bits |= (static_cast<uint32_t>(static_cast<uint8_t>(in[block + j]))) << (8 * j);
    const float scale = __uint_as_float(bits);
    for (int e = lane; e < block; e += 32) {
      const int64_t c = col0 + e;
      if (c < n) orow[c] = static_cast<float>(in[e]) * scale;
    }
  }
}

int grid_for(int64_t n_blocks) {
  return static_cast<int>((n_blocks + WARPS - 1) / WARPS);
}

bool bad_shape(long long rows, long long n, int block) {
  if (rows < 1 || n < 1 || block < 1) return true;
  const long long nb = (n + block - 1) / block;
  // one CTA per WARPS blocks: the grid's x extent must stay below 2^31
  return (rows * nb + WARPS - 1) / WARPS >= (1LL << 31);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  x [rows, n] contiguous; wire
// [rows, ceil(n / block), block + 4] int8.  Returns the cudaError_t of the
// launch (0 = accepted); refuses empty or oversized shapes with
// cudaErrorInvalidValue.
extern "C" int qint8_pack_launch(const void* x, void* wire, int dtype, long long rows,
                                 long long n, int block, int device, void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(rows, n, block)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = (n + block - 1) / block;
  const int64_t n_blocks = rows * nb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* w = static_cast<int8_t*>(wire);
  if (dtype == 0)
    qint8_pack_kernel<uint32_t><<<grid_for(n_blocks), THREADS, 0, s>>>(
        static_cast<const uint32_t*>(x), w, n_blocks, nb, n, block);
  else if (dtype == 1)
    qint8_pack_kernel<uint16_t><<<grid_for(n_blocks), THREADS, 0, s>>>(
        static_cast<const uint16_t*>(x), w, n_blocks, nb, n, block);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// wire [rows, nb, block + 4] int8 contiguous -> out [rows, n] fp32, with
// nb == ceil(n / block).  Returns the cudaError_t of the launch.
extern "C" int qint8_unpack_launch(const void* wire, void* out, long long rows, long long n,
                                   int block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bad_shape(rows, n, block)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t nb = (n + block - 1) / block;
  const int64_t n_blocks = rows * nb;
  qint8_unpack_kernel<<<grid_for(n_blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(wire), static_cast<float*>(out), n_blocks, nb, n, block);
  return static_cast<int>(cudaGetLastError());
}
