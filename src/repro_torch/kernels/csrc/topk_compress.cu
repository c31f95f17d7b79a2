// Exact per-row magnitude top-k for Hopper (sm_90a): the sparse reducer's
// compress step (repro_torch/comm/sparse.py), for many segments in one call.
//
// Replaces the Pallas TPU kernel repro/kernels/topk_compress.py::topk_compress
// (bodies _threshold_select, _topk_kernel_scan, _topk_kernel_onehot) and
// computes exactly what repro/kernels/ref.py::topk_compress_ref computes:
// lax.top_k(|x as fp32|, k) with ties at the k-th magnitude going to the
// lowest indices, the k indices then sorted ascending and the values
// gathered from x.  A call takes a table of segments, each (x [rows, n],
// vals [rows, k], idx [rows, k], rows, n, k), all fp32 or all bf16; vals
// are x's bits (subnormals and -0.0 kept), idx int32 ascending per row.
// 1 <= rows <= 65535, 1 <= n < 2^31, 1 <= k <= n.
//
// Bound: bytes.  A call must read every x once and write rows * k *
// (element + 4) bytes, with a few integer operations per element.  One
// global fire of ResNet-18 at width 64 and 16 learners (55 leaves,
// 11,172,160 fp32 parameters each) moves 786,519,936 B: 0.235 ms at
// 3.35 TB/s.  One fire of rwkv6-1.6b at 4 layers and 4 learners (25
// leaves, 1,961,304,064 fp32 elements) moves 8.63 GB: 2.58 ms.
//
// Design.  The key of an element is the fp32 bit pattern of |x| (bf16
// widened), a 31-bit integer whose order is the magnitude order.  The
// k-th largest key t is fixed digit by digit from the top, DIGIT1 + DIGIT2
// + DIGIT3 = 11 + 11 + 9 bits; fill = k - #(key > t) of the keys equal to
// t are taken, the lowest-indexed ones.
//   * Small rows (n <= SMALL_N): one CTA per row (topk_small).  The row
//     sits in shared memory; the CTA walks the three digits over it and
//     ranks the row in index order.  One read of x.  All small rows of a
//     call share the launch, whose extra CTAs clear the large rows' state.
//   * Large rows, four launches, three reads of x.  The histogram passes
//     run a grid flattened over (segment, row, span of SPAN elements); a CTA
//     adds its shared-memory histogram into its row's, and the row's last
//     CTA (a __threadfence and an atomic ticket per row) fixes the digit
//     there, clears the histogram for the next pass and leaves the rest in
//     the row's state, so no launch exists only to pass a digit on.
//       A (topk_digit<0>) reads x: key bits 30..20.  It also clears the
//         look-back words of pass D.
//       B (topk_digit<1>) reads x: bits 19..9 of the keys in digit 1's bin,
//         and, when pass A counted at most cap of them (cap = n >>
//         CAP_SHIFT keys a row), appends those keys to the row's candidate
//         buffer: staged per warp in shared memory, one atomic per flush.
//       C (topk_digit<2>) reads the candidates, or x where the bin
//         overflowed the buffer (a fourth read, for rows such as +-1 or
//         mostly zero): bits 8..0; fixes t and fill.  Candidates are in
//         the order the scheduler wrote them; only counts are taken from
//         them, so the outputs stay deterministic.
//       D (topk_compact) reads x in CHUNK-element chunks taken by an atomic
//         ticket, chunk-major over a segment's rows (a chunk only waits on
//         chunks that have started, and the chunks in flight spread over
//         the rows).  Thread i holds masks of its 32 elements above and
//         equal to t; the CTA publishes its (gt, eq) counts as one 64-bit
//         word (2-bit flag, two 31-bit counts, relaxed stores and loads:
//         the word carries its own payload) and sums its predecessors' by a
//         decoupled look-back (Merrill & Garland, "Single-pass Parallel
//         Prefix Scan with Decoupled Look-back", 2016), a warp at a time
//         over 32 words.  Then kept_before = gt_before + min(fill,
//         eq_before); two block scans rank the kept elements in index order
//         and each warp writes its kept x[i] (read again, from L2) and i with
//         consecutive lanes on consecutive slots.  Only the chunk where the
//         taken ties run out takes part of its ties.
//   Loads are 16-byte vectors (4 fp32 or 8 bf16), U of them in flight a
//   thread while the last batch is processed, with scalar loads where a
//   row does not start on 16 bytes.  Histograms add a run of equal bins
//   once (BinCache), so mostly-zero rows do not serialize on one
//   shared-memory address.
// Reads of x: 1 per small row, 3 per large row (4 where the candidates
// overflow), plus the candidates (about 3% of x for Gaussian rows): three
// reads of one ResNet-18 fire are 0.64 ms at 3.35 TB/s, of one rwkv6 fire
// 7.0 ms.
// Launches per call: topk_small (when there are small rows or large ones
// to clear) and, when there are large rows, topk_digit x 3 and
// topk_compact: at most 5, with no memset; the wrapper uploads the segment
// table with one host-to-device copy.
// Deterministic: no sort and no float atomics; every output slot follows
// from integer counts.  Offsets are 64-bit.
//
// Built with nvcc into a plain-C shared library and loaded with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/topk_compress.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <vector>

namespace {

constexpr int THREADS = 256;                       // per CTA of topk_small and topk_digit
constexpr int D_THREADS = 512;                     // per CTA of topk_compact
constexpr int IPT = 32;                            // elements a thread ranks
constexpr int DIGIT1 = 11;                         // key bits 30..20
constexpr int DIGIT2 = 11;                         // bits 19..9
constexpr int DIGIT3 = 31 - DIGIT1 - DIGIT2;       // bits 8..0
constexpr int SHIFT1 = 31 - DIGIT1;
constexpr int SHIFT2 = SHIFT1 - DIGIT2;
constexpr int BINS = 1 << (DIGIT1 > DIGIT2 ? DIGIT1 : DIGIT2);
constexpr int CHUNK = 16384;                       // elements per CTA of pass D
constexpr int SPAN = 4 * CHUNK;                    // elements per CTA of passes A-C
constexpr int SMALL_N = 8192;                      // rows up to this take one CTA
constexpr int CAP_SHIFT = 4;                       // candidates per row: n >> CAP_SHIFT
constexpr int U = 4;                               // 16-byte loads a thread has in flight
constexpr int D_U = 2;                             // the same in pass D
constexpr int D_MIN_BLOCKS = 3;                    // pass D's CTAs per SM (registers)
constexpr int STAGE = 8192;                        // pass B's staged candidates per CTA
static_assert(CHUNK == D_THREADS * IPT, "a thread of pass D ranks 32 elements");
static_assert(SMALL_N <= THREADS * IPT, "a thread of topk_small ranks 32 elements");
static_assert(SPAN % CHUNK == 0, "pass A clears whole chunks' look-back words");
static_assert((1 << DIGIT3) >= THREADS, "find_digit takes a bin per thread");

// per large row: its histogram, then these ints
enum : int { ST_TICKET = BINS, ST_CANDS, ST_PREFIX, ST_LEFT, ST_USE_CANDS, ST_T,
             ST_FILL, STATE_INTS = BINS + 16 };
static_assert(STATE_INTS % 4 == 0, "the state is cleared as uint4");

// the segment table: int64 fields per segment.  The caller sets X..K and CAP
// (-1: n >> CAP_SHIFT); topk_compress_plan sets the rest.
enum : int { F_X, F_VALS, F_IDX, F_ROWS, F_N, F_K, F_START, F_DSTART, F_ROW0, F_CAND,
             F_STATUS, F_NSPANS, F_NCHUNKS, F_CAP, SEG_FIELDS = 16 };

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long FLAG_AGG = 1ull << 62;    // the chunk's own counts
constexpr unsigned long long FLAG_INCL = 2ull << 62;   // counts through the chunk

template <typename T>
__device__ __forceinline__ uint32_t widen(uint32_t raw) {
  return sizeof(T) == 2 ? raw << 16 : raw;
}

__device__ __forceinline__ uint32_t key_of(uint32_t w) { return w & 0x7fffffffu; }

template <typename T>
__device__ __forceinline__ T narrow(uint32_t w) {
  return static_cast<T>(sizeof(T) == 2 ? w >> 16 : w);
}

// the elements of a 16-byte vector, widened to fp32 bits, in index order
template <typename T>
__device__ __forceinline__ void unpack(uint4 q, uint32_t (&w)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    w[0] = q.x; w[1] = q.y; w[2] = q.z; w[3] = q.w;
  } else {
    const uint32_t p[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[2 * j] = p[j] << 16;
      w[2 * j + 1] = p[j] & 0xffff0000u;
    }
  }
}

// shared-memory slot of element i of a chunk: one pad word per 32, so a
// thread's 32 consecutive elements fall in 32 banks across the warp
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Exclusive scan of one int per thread over the CTA; *total gets the sum.
// Every thread of the CTA must call it.  sh holds 32 ints.
__device__ int block_exclusive_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();                        // the previous call's reads of sh are done
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) sh[lane] = s;      // inclusive warp prefixes
  }
  __syncthreads();
  *total = sh[nwarps - 1];
  return (warp ? sh[warp - 1] : 0) + x - v;
}

// Adds a run of equal bins to a shared-memory histogram with one atomic.
struct BinCache {
  int bin = -1, count = 0;
  __device__ __forceinline__ void add(int* h, int b) {
    if (b == bin) {
      ++count;
      return;
    }
    if (count) atomicAdd(h + bin, count);
    bin = b;
    count = 1;
  }
  __device__ __forceinline__ void flush(int* h) {
    if (count) atomicAdd(h + bin, count);
    count = 0;
  }
};

// Walk the shared-memory histogram h (nbins >= THREADS) from the top bin down
// to the one that holds the left-th largest key.  out = {digit, left less the
// keys in the bins above it, keys in its bin}.  Ends with a barrier.
__device__ void find_digit(const int* h, int nbins, int left, int* sh, int* out) {
  const int per = nbins / THREADS;
  const int top = nbins - static_cast<int>(threadIdx.x) * per;   // bins [top - per, top)
  int s = 0;
  for (int j = 1; j <= per; ++j) s += h[top - j];
  int total;
  int above = block_exclusive_scan(s, sh, &total);
  if (above < left && above + s >= left) {
    for (int j = 1; j <= per; ++j) {
      const int c = h[top - j];
      if (above + c >= left) {
        out[0] = top - j;
        out[1] = left - above;
        out[2] = c;
        break;
      }
      above += c;
    }
  }
  __syncthreads();
}

// The segment in [lo, hi) whose grid range holds id: the last one whose field
// f is <= id (every segment's range is non-empty, so the starts ascend).
__device__ int find_seg(const long long* tab, int lo, int hi, int f, long long id, int* sh) {
  if (threadIdx.x < 32) {
    int count = 0;
    for (int base = lo; base < hi; base += 32) {
      const int s = base + static_cast<int>(threadIdx.x);
      const bool le = s < hi && __ldg(tab + static_cast<int64_t>(s) * SEG_FIELDS + f) <= id;
      count += __popc(__ballot_sync(FULL, le));
    }
    if (threadIdx.x == 0) *sh = lo + count - 1;
  }
  __syncthreads();
  return *sh;
}

// Calls f(w, i0, cnt) for the elements of xr[lo, hi), a 16-byte vector at a
// time: w holds 16 / sizeof(T) elements widened to fp32 bits, the first cnt of
// them valid, element j at index i0 + j.  First one scalar step (cnt 0 or 1)
// for the head and tail that vectors do not cover, then the vectors, NT * U a
// batch, each batch followed by batch_end(); the next batch's loads are in
// flight while a batch is processed.  Every thread of the CTA (NT threads)
// takes every step, so f may use warp shuffles.
template <typename T, int NT, int U, typename F, typename G>
__device__ __forceinline__ void visit(const T* xr, int64_t lo, int64_t hi, F&& f,
                                      G&& batch_end) {
  constexpr int V = 16 / sizeof(T);
  constexpr int64_t STEP = static_cast<int64_t>(NT) * U;
  const uint64_t e0 = reinterpret_cast<uintptr_t>(xr + lo) / sizeof(T);
  const int64_t a0 = min(hi, lo + static_cast<int64_t>((V - e0 % V) % V));
  const int64_t nvec = (hi - a0) / V;
  const int64_t a1 = a0 + nvec * V;
  const int nh = static_cast<int>(a0 - lo), nt = static_cast<int>(hi - a1);
  const uint4* vp = reinterpret_cast<const uint4*>(xr + a0);
  uint4 q[U];
  auto fetch = [&](int64_t v0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = v0 + u * NT + threadIdx.x;
      q[u] = v < nvec ? __ldg(vp + v) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  fetch(0);
  {
    const int j = threadIdx.x;
    const bool ok = j < nh + nt;
    const int64_t i = j < nh ? lo + j : a1 + (j - nh);
    uint32_t w[V] = {};
    w[0] = ok ? widen<T>(static_cast<uint32_t>(xr[i])) : 0u;
    f(w, i, ok ? 1 : 0);
    batch_end();
  }
  for (int64_t v0 = 0; v0 < nvec; v0 += STEP) {
    uint4 cur[U];
#pragma unroll
    for (int u = 0; u < U; ++u) cur[u] = q[u];
    if (v0 + STEP < nvec) fetch(v0 + STEP);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t v = v0 + u * NT + threadIdx.x;
      uint32_t w[V];
      unpack<T>(cur[u], w);
      f(w, a0 + v * V, v < nvec ? V : 0);
    }
    batch_end();
  }
}

// Rank this thread's elements over the CTA in index order (bit j of gtm and
// eqm: element first + j is above t, equal to t; thread i's first is the
// CTA's first + 32 i) and write the kept ones: every key above t, and the
// ties while fewer than fill ties are taken in the row.  eq_before and
// kept_before count the row's ties and kept elements before the CTA's first
// element; value(i) gives element i's bits.  A warp's kept elements take
// consecutive slots, so its lanes write them on consecutive slots.
template <typename T, typename Val>
__device__ __forceinline__ void rank_write(uint32_t gtm, uint32_t eqm, int fill, int eq_before,
                                           int kept_before, int64_t first, T* vr, int* ir,
                                           int k, int* sh, Val&& value) {
  int total;
  // the row's ties before this thread's first one
  const int rank = eq_before + block_exclusive_scan(__popc(eqm), sh, &total);
  uint32_t keep = gtm;
  int take = min(max(fill - rank, 0), __popc(eqm));
  for (uint32_t m = eqm; take > 0; --take) {   // the lowest-indexed ties
    const uint32_t b = m & (0u - m);
    keep |= b;
    m ^= b;
  }
  const int cnt = __popc(keep);
  const int off = block_exclusive_scan(cnt, sh, &total);   // this thread's first slot
  const int lane = threadIdx.x & 31;
  const int base = __shfl_sync(FULL, off, 0);
  const int n = __shfl_sync(FULL, off + cnt, 31) - base;   // the warp's kept elements
  const int incl = off + cnt - base;      // the warp's kept elements through this lane
  for (int r0 = 0; r0 < n; r0 += 32) {
    const int r = r0 + lane;
    // o: the lane holding the warp's r-th kept element (the first with incl > r)
    int o = 0;
#pragma unroll
    for (int step = 16; step; step >>= 1)
      if (__shfl_sync(FULL, incl, o + step - 1) <= r) o += step;
    const uint32_t m = __shfl_sync(FULL, keep, o);
    const int before = __shfl_sync(FULL, incl - cnt, o);
    if (r < n) {
      const int64_t i = first + (o - lane) * IPT + __fns(m, 0, r - before + 1);
      const int slot = kept_before + base + r;
      if (slot < k) {
        vr[slot] = value(i);
        ir[slot] = static_cast<int>(i);
      }
    }
  }
}

// Small rows, one CTA each; CTAs past small_rows clear nzero uint4 of the large
// rows' state (and pass D's ticket) for the passes that follow.
template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_small(const long long* __restrict__ tab, int nsmall, int small_rows,
           uint4* __restrict__ zero, long long nzero) {
  __shared__ uint32_t w[SMALL_N + SMALL_N / 32];
  __shared__ int h[BINS];
  __shared__ int sh[32];
  __shared__ int s_seg, out[3];
  if (static_cast<int>(blockIdx.x) >= small_rows) {
    const int64_t first = static_cast<int64_t>(blockIdx.x - small_rows) * THREADS * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int64_t i = first + j * THREADS + threadIdx.x;
      if (i < nzero) zero[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int seg = find_seg(tab, 0, nsmall, F_START, blockIdx.x, &s_seg);
  const long long* e = tab + static_cast<int64_t>(seg) * SEG_FIELDS;
  const int n = static_cast<int>(e[F_N]), k = static_cast<int>(e[F_K]);
  const int64_t row = blockIdx.x - e[F_START];
  const T* xr = reinterpret_cast<const T*>(e[F_X]) + row * n;
  visit<T, THREADS, U>(xr, 0, n, [&](const uint32_t* v, int64_t i0, int cnt) {
#pragma unroll
    for (int j = 0; j < 16 / static_cast<int>(sizeof(T)); ++j)
      if (j < cnt) w[pad(static_cast<int>(i0) + j)] = v[j];
  }, [] {});
  __syncthreads();
  uint32_t prefix = 0;
  int left = k;
#pragma unroll 1
  for (int p = 0; p < 3; ++p) {
    const int bits = p == 0 ? DIGIT1 : p == 1 ? DIGIT2 : DIGIT3;
    const int shift = p == 0 ? SHIFT1 : p == 1 ? SHIFT2 : 0;
    const int above = shift + bits;       // the digits fixed so far sit above
    const int nb = 1 << bits;
    for (int b = threadIdx.x; b < nb; b += THREADS) h[b] = 0;
    __syncthreads();
    BinCache cache;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const uint32_t key = key_of(w[pad(i)]);
      if ((key >> above) == prefix) cache.add(h, (key >> shift) & (nb - 1));
    }
    cache.flush(h);
    __syncthreads();
    find_digit(h, nb, left, sh, out);
    prefix = (prefix << bits) | static_cast<uint32_t>(out[0]);
    left = out[1];
  }
  // thread i ranks elements [32 i, 32 i + 32)
  const int base = threadIdx.x * IPT;
  uint32_t gtm = 0, eqm = 0;
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    if (base + j < n) {
      const uint32_t key = key_of(w[pad(base + j)]);
      gtm |= static_cast<uint32_t>(key > prefix) << j;
      eqm |= static_cast<uint32_t>(key == prefix) << j;
    }
  }
  rank_write<T>(gtm, eqm, left, 0, 0, base, reinterpret_cast<T*>(e[F_VALS]) + row * k,
                reinterpret_cast<int*>(e[F_IDX]) + row * k, k, sh,
                [&](int64_t i) { return narrow<T>(w[pad(static_cast<int>(i))]); });
}

// Pass A, B or C over the large rows: grid (segment, row, span) flattened.
template <typename T, int PASS>
__global__ void __launch_bounds__(THREADS)
topk_digit(const long long* __restrict__ tab, int nsmall, int nseg, int* __restrict__ state,
           unsigned long long* __restrict__ status, uint32_t* __restrict__ cands) {
  constexpr int BITS = PASS == 0 ? DIGIT1 : PASS == 1 ? DIGIT2 : DIGIT3;
  constexpr int NB = 1 << BITS;
  constexpr int SHIFT = PASS == 0 ? SHIFT1 : PASS == 1 ? SHIFT2 : 0;
  constexpr int ABOVE = SHIFT + BITS;     // keys whose bits from here match the prefix
  // pass B stages its candidates per warp, WSTAGE a warp, and appends them
  // to the row's buffer when the next batch might not fit
  constexpr int WSTAGE = STAGE / (THREADS / 32);
  constexpr int WBATCH = 32 * U * (16 / sizeof(T));       // a warp's elements a batch
  static_assert(WSTAGE >= WBATCH, "a warp stages at least a batch");
  __shared__ int h[NB];
  __shared__ uint32_t buf[PASS == 1 ? STAGE : 1];
  __shared__ int sh[32];
  __shared__ int s_seg, s_last, out[3];
  const int seg = find_seg(tab, nsmall, nseg, F_START, blockIdx.x, &s_seg);
  const long long* e = tab + static_cast<int64_t>(seg) * SEG_FIELDS;
  const int64_t n = e[F_N];
  const int nspans = static_cast<int>(e[F_NSPANS]);
  const int64_t local = blockIdx.x - e[F_START];
  const int row = static_cast<int>(local / nspans), span = static_cast<int>(local % nspans);
  int* st = state + (e[F_ROW0] + row) * STATE_INTS;
  for (int b = threadIdx.x; b < NB; b += THREADS) h[b] = 0;
  if (PASS == 0 && threadIdx.x < SPAN / CHUNK) {     // pass D's look-back words
    const int64_t c = static_cast<int64_t>(span) * (SPAN / CHUNK) + threadIdx.x;
    if (c < e[F_NCHUNKS]) status[e[F_STATUS] + row * e[F_NCHUNKS] + c] = 0ull;
  }
  const uint32_t prefix = PASS ? static_cast<uint32_t>(st[ST_PREFIX]) : 0u;
  const bool use_cands = PASS ? st[ST_USE_CANDS] != 0 : false;
  uint32_t* cr = cands + e[F_CAND] + row * e[F_CAP];
  __syncthreads();
  BinCache cache;
  const int lane = threadIdx.x & 31;
  uint32_t* wbuf = buf + (threadIdx.x >> 5) * WSTAGE;
  int wcount = 0;                         // the warp's staged candidates
  auto warp_flush = [&] {
    __syncwarp();
    int base = 0;
    if (lane == 0) base = atomicAdd(st + ST_CANDS, wcount);
    base = __shfl_sync(FULL, base, 0);
    for (int j = lane; j < wcount; j += 32) cr[base + j] = wbuf[j];
    __syncwarp();
    wcount = 0;
  };
  if (PASS == 2 && use_cands) {
    const int nc = st[ST_CANDS];
    for (int64_t i = static_cast<int64_t>(span) * THREADS + threadIdx.x; i < nc;
         i += static_cast<int64_t>(nspans) * THREADS) {
      const uint32_t key = cr[i];
      if ((key >> ABOVE) == prefix) cache.add(h, key & (NB - 1));
    }
  } else {
    const T* xr = reinterpret_cast<const T*>(e[F_X]) + row * n;
    const int64_t lo = static_cast<int64_t>(span) * SPAN, hi = min(lo + SPAN, n);
    const bool stage = PASS == 1 && use_cands;
    visit<T, THREADS, U>(xr, lo, hi, [&](const uint32_t* v, int64_t, int cnt) {
      constexpr int V = 16 / sizeof(T);
      int m = 0;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const uint32_t key = key_of(v[j]);
        const bool in = j < cnt && (key >> ABOVE) == prefix;
        if (in) cache.add(h, (key >> SHIFT) & (NB - 1));
        m += in;
      }
      if (PASS == 1 && stage) {           // stage the candidates, a warp at a time
        int incl = m;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += y;
        }
        int pos = wcount + incl - m;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const uint32_t key = key_of(v[j]);
          if (j < cnt && (key >> ABOVE) == prefix) wbuf[pos++] = key;
        }
        wcount += __shfl_sync(FULL, incl, 31);
      }
    }, [&] {
      if (PASS == 1 && stage && wcount > WSTAGE - WBATCH) warp_flush();
    });
    if (stage && wcount) warp_flush();
  }
  cache.flush(h);
  __syncthreads();
  int* gh = st;                           // the row's histogram
  for (int b = threadIdx.x; b < NB; b += THREADS) {
    const int c = h[b];
    if (c) atomicAdd(gh + b, c);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(st + ST_TICKET, 1) == nspans - 1;
  __syncthreads();
  if (!s_last) return;
  // the row's last CTA: every other CTA's histogram is in, fix the digit
  __threadfence();
  for (int b = threadIdx.x; b < NB; b += THREADS) {
    h[b] = __ldcg(gh + b);
    gh[b] = 0;                            // cleared for the next pass
  }
  __syncthreads();
  const int left = PASS ? st[ST_LEFT] : static_cast<int>(e[F_K]);
  find_digit(h, NB, left, sh, out);
  if (threadIdx.x == 0) {
    const uint32_t p = (prefix << BITS) | static_cast<uint32_t>(out[0]);
    if (PASS == 2) {
      st[ST_T] = static_cast<int>(p);
      st[ST_FILL] = out[1];
    } else {
      st[ST_PREFIX] = static_cast<int>(p);
      st[ST_LEFT] = out[1];
    }
    if (PASS == 0) st[ST_USE_CANDS] = out[2] <= e[F_CAP];
    st[ST_TICKET] = 0;
  }
}

__device__ __forceinline__ unsigned long long status_word(unsigned long long flag, int g,
                                                          int q) {
  return flag | static_cast<unsigned long long>(g) << 31 | static_cast<unsigned>(q);
}

// Warp 0: publish the chunk's counts and sum its predecessors' (decoupled
// look-back).  out = {gt, eq} over the row's chunks before this one.
__device__ void lookback(unsigned long long* rs, int chunk, int gt, int eq, int* out) {
  const int lane = threadIdx.x & 31;
  if (lane == 0)          // the first chunk of a row: its counts from the row's start
    st_relaxed(rs + chunk, status_word(chunk ? FLAG_AGG : FLAG_INCL, gt, eq));
  int gt_b = 0, eq_b = 0;
  for (int j = chunk - 1; j >= 0; j -= 32) {
    const int p = j - lane;
    unsigned long long s = p >= 0 ? ld_relaxed(rs + p) : FLAG_INCL;
    while (__any_sync(FULL, (s >> 62) == 0))
      if ((s >> 62) == 0) s = ld_relaxed(rs + p);
    const unsigned incl = __ballot_sync(FULL, (s >> 62) == 2);
    // up to the nearest chunk whose counts run from the row's start
    const bool take = incl == 0 || lane < __ffs(incl);
    int g = take ? static_cast<int>((s >> 31) & 0x7fffffffu) : 0;
    int q = take ? static_cast<int>(s & 0x7fffffffu) : 0;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      g += __shfl_xor_sync(FULL, g, o);
      q += __shfl_xor_sync(FULL, q, o);
    }
    gt_b += g;
    eq_b += q;
    if (incl) break;
  }
  if (lane == 0) {
    if (chunk) st_relaxed(rs + chunk, status_word(FLAG_INCL, gt_b + gt, eq_b + eq));
    out[0] = gt_b;
    out[1] = eq_b;
  }
}

// Pass D over the large rows: chunks (segment, row, chunk) in ticket order.
// Thread i of a chunk ranks its elements [32 i, 32 i + 32) from registers.
template <typename T>
__global__ void __launch_bounds__(D_THREADS, D_MIN_BLOCKS)
topk_compact(const long long* __restrict__ tab, int nsmall, int nseg,
             const int* __restrict__ state, unsigned long long* __restrict__ status,
             int* __restrict__ ticket) {
  constexpr int V = 16 / sizeof(T);
  static_assert((IPT / V) % D_U == 0, "a thread's vectors come D_U at a time");
  __shared__ int sh[32];
  __shared__ int s_id, s_seg, s_before[2];
  if (threadIdx.x == 0) s_id = atomicAdd(ticket, 1);
  __syncthreads();
  const int id = s_id;
  const int seg = find_seg(tab, nsmall, nseg, F_DSTART, id, &s_seg);
  const long long* e = tab + static_cast<int64_t>(seg) * SEG_FIELDS;
  const int64_t n = e[F_N];
  const int k = static_cast<int>(e[F_K]);
  // chunk-major over the segment's rows, so that the chunks in flight
  // spread over its rows and each look-back walks back over fewer of them
  const int64_t local = id - e[F_DSTART];
  const int64_t row = local % e[F_ROWS];
  const int chunk = static_cast<int>(local / e[F_ROWS]);
  const int* st = state + (e[F_ROW0] + row) * STATE_INTS;
  const uint32_t t = static_cast<uint32_t>(st[ST_T]);
  const int fill = st[ST_FILL];
  const T* xr = reinterpret_cast<const T*>(e[F_X]) + row * n;
  const int64_t lo = static_cast<int64_t>(chunk) * CHUNK, hi = min(lo + CHUNK, n);
  const int64_t first = lo + static_cast<int64_t>(threadIdx.x) * IPT;
  // a row that does not start on 16 bytes is read element by element
  const bool aligned = reinterpret_cast<uintptr_t>(xr + lo) % 16 == 0;
  uint32_t gtm = 0, eqm = 0;
#pragma unroll
  for (int b = 0; b < IPT / V; b += D_U) {
    uint32_t w[D_U][V];
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
      const int64_t i0 = first + (b + u) * V;
      if (aligned && i0 + V <= hi) {
        unpack<T>(__ldg(reinterpret_cast<const uint4*>(xr + i0)), w[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          w[u][j] = i0 + j < hi ? widen<T>(static_cast<uint32_t>(xr[i0 + j])) : 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < D_U; ++u) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int bit = (b + u) * V + j;
        const uint32_t key = key_of(w[u][j]);
        const bool ok = first + bit < hi;
        gtm |= static_cast<uint32_t>(ok && key > t) << bit;
        eqm |= static_cast<uint32_t>(ok && key == t) << bit;
      }
    }
  }
  int both;
  block_exclusive_scan(__popc(gtm) | __popc(eqm) << 16, sh, &both);   // each <= CHUNK < 2^16
  const int gt = both & 0xffff;
  const int eq = both >> 16;
  if (threadIdx.x < 32)
    lookback(status + e[F_STATUS] + row * e[F_NCHUNKS], chunk, gt, eq, s_before);
  __syncthreads();
  const int gt_before = s_before[0];
  const int eq_before = s_before[1];
  if (gt + min(max(fill - eq_before, 0), eq) == 0) return;   // uniform over the CTA
  // the kept values are read again (from L2: the chunk was just read)
  rank_write<T>(gtm, eqm, fill, eq_before, gt_before + min(fill, eq_before), first,
                reinterpret_cast<T*>(e[F_VALS]) + row * k,
                reinterpret_cast<int*>(e[F_IDX]) + row * k, k, sh,
                [&](int64_t i) { return xr[i]; });
}

// Scratch layout in bytes: the large rows' state and pass D's ticket, the
// look-back words, the candidates.
struct Layout {
  long long state_ints, status_off, cand_off, bytes;
};

long long align16(long long b) { return (b + 15) / 16 * 16; }

Layout layout(long long large_rows, long long status_words, long long cand_words) {
  Layout l;
  l.state_ints = large_rows ? large_rows * STATE_INTS + 4 : 0;
  l.status_off = align16(l.state_ints * 4);
  l.cand_off = align16(l.status_off + status_words * 8);
  l.bytes = std::max(16LL, align16(l.cand_off + cand_words * 4));
  return l;
}

enum : int { T_NSMALL, T_SMALL_ROWS, T_SPANS, T_DCTAS, T_LARGE_ROWS, T_CANDS, T_STATUS,
             T_BYTES, TOTALS };

long long zero_ctas(const Layout& l) {
  return (l.state_ints / 4 + THREADS * 8 - 1) / (THREADS * 8);
}

template <typename T>
cudaError_t run(const long long* tab, const long long* tot, int nseg, char* scratch,
                cudaStream_t s) {
  cudaError_t err;
  const Layout l = layout(tot[T_LARGE_ROWS], tot[T_STATUS], tot[T_CANDS]);
  const int nsmall = static_cast<int>(tot[T_NSMALL]);
  const int small_rows = static_cast<int>(tot[T_SMALL_ROWS]);
  int* state = reinterpret_cast<int*>(scratch);
  auto* status = reinterpret_cast<unsigned long long*>(scratch + l.status_off);
  auto* cands = reinterpret_cast<uint32_t*>(scratch + l.cand_off);
  const long long zc = zero_ctas(l);
  if (small_rows + zc > 0) {
    topk_small<T><<<static_cast<unsigned>(small_rows + zc), THREADS, 0, s>>>(
        tab, nsmall, small_rows, reinterpret_cast<uint4*>(scratch), l.state_ints / 4);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const unsigned spans = static_cast<unsigned>(tot[T_SPANS]);
  if (!spans) return cudaSuccess;
  topk_digit<T, 0><<<spans, THREADS, 0, s>>>(tab, nsmall, nseg, state, status, cands);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_digit<T, 1><<<spans, THREADS, 0, s>>>(tab, nsmall, nseg, state, status, cands);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_digit<T, 2><<<spans, THREADS, 0, s>>>(tab, nsmall, nseg, state, status, cands);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  topk_compact<T><<<static_cast<unsigned>(tot[T_DCTAS]), D_THREADS, 0, s>>>(
      tab, nsmall, nseg, state, status, state + tot[T_LARGE_ROWS] * STATE_INTS);
  return cudaGetLastError();
}

}  // namespace

// Plan a call on the host: check each segment of tab (nseg x SEG_FIELDS
// int64, X..K and CAP set), order the small segments first, fill the grid
// offsets, and write the totals (TOTALS int64).  Returns the bytes of scratch
// the call needs, or -1 if a segment is out of range or the grid too large.
extern "C" long long topk_compress_plan(long long* tab, int nseg, long long* tot) {
  if (nseg < 1) return -1;
  std::vector<long long> in(tab, tab + static_cast<size_t>(nseg) * SEG_FIELDS);
  for (int s = 0; s < nseg; ++s) {
    const long long* e = &in[static_cast<size_t>(s) * SEG_FIELDS];
    if (e[F_ROWS] < 1 || e[F_ROWS] > 65535 || e[F_N] < 1 || e[F_N] >= (1LL << 31) ||
        e[F_K] < 1 || e[F_K] > e[F_N])
      return -1;
  }
  long long small_rows = 0, spans = 0, dctas = 0, large_rows = 0, cand = 0, status = 0;
  int out = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int s = 0; s < nseg; ++s) {
      const long long* e = &in[static_cast<size_t>(s) * SEG_FIELDS];
      const bool small = e[F_N] <= SMALL_N;
      if (small != (pass == 0)) continue;
      long long* o = tab + static_cast<size_t>(out++) * SEG_FIELDS;
      std::copy(e, e + SEG_FIELDS, o);
      const long long rows = e[F_ROWS], n = e[F_N];
      if (small) {
        o[F_START] = small_rows;
        small_rows += rows;
        o[F_DSTART] = o[F_ROW0] = o[F_CAND] = o[F_STATUS] = 0;
        o[F_NSPANS] = o[F_NCHUNKS] = o[F_CAP] = 0;
        continue;
      }
      o[F_NSPANS] = (n + SPAN - 1) / SPAN;
      o[F_NCHUNKS] = (n + CHUNK - 1) / CHUNK;
      o[F_CAP] = e[F_CAP] >= 0 ? std::min(e[F_CAP], n) : n >> CAP_SHIFT;
      o[F_START] = spans;
      o[F_DSTART] = dctas;
      o[F_ROW0] = large_rows;
      o[F_CAND] = cand;
      o[F_STATUS] = status;
      spans += rows * o[F_NSPANS];
      dctas += rows * o[F_NCHUNKS];
      large_rows += rows;
      cand += rows * o[F_CAP];
      status += rows * o[F_NCHUNKS];
    }
    if (pass == 0) tot[T_NSMALL] = out;
  }
  const Layout l = layout(large_rows, status, cand);
  if (spans > INT_MAX || dctas > INT_MAX || small_rows + zero_ctas(l) > INT_MAX ||
      large_rows > INT_MAX)
    return -1;
  tot[T_SMALL_ROWS] = small_rows;
  tot[T_SPANS] = spans;
  tot[T_DCTAS] = dctas;
  tot[T_LARGE_ROWS] = large_rows;
  tot[T_CANDS] = cand;
  tot[T_STATUS] = status;
  tot[T_BYTES] = l.bytes;
  return l.bytes;
}

// Launch a planned call: tab is the planned table in device memory, tot the
// plan's totals (host), scratch tot[T_BYTES] bytes that need no clearing.
// dtype codes: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the
// launches (cudaGetLastError after each); 0 means all were accepted.
extern "C" int topk_compress_run(const long long* tab, const long long* tot, int nseg,
                                 void* scratch, int dtype, int device, void* stream) {
  // this library carries its own CUDA runtime: select the caller's device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  if (dtype == 0)
    err = run<uint32_t>(tab, tot, nseg, sc, s);
  else if (dtype == 1)
    err = run<uint16_t>(tab, tot, nseg, sc, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The number of int64 totals topk_compress_plan writes.
extern "C" int topk_compress_totals() { return TOTALS; }
