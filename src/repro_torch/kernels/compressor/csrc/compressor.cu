// Fused compressor kernels of FLECS-CGD for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/compressor/
// compressor.py:
//   fused_dither_kernel        <- _fused_dither_kernel  (compressor.py:71)
//   fused_dither_keyed_kernel  <- the same, with the per-worker keys and the
//                                 uniforms drawn in the kernel
//   fused_topk_kernel          <- _fused_topk_kernel    (compressor.py:105)
//   dither_bits_kernel         <- _dither_bits_kernel   (compressor.py:161)
//   topk_bits_kernel           <- _topk_bits_kernel     (compressor.py:165)
//   grouped_*_kernel           <- the same four, over a grid of G points in
//                                 one launch (below)
//
// Layout: x is [n, L] float32, row-major and contiguous; one row is one
// worker's whole message (a gradient difference, L = d, or a flattened
// [d, m] Hessian-sketch difference, L = d*m).  The infinity norm and the
// top-k threshold are taken over the whole row.  The u-taking fused_dither
// takes one CTA a row; fused_dither_keyed and fused_topk a thread-block
// cluster of C CTAs a row (below).
//
// Exactness: every kernel evaluates the reference expressions of
// repro.core.compressors in the same order with round-to-nearest
// intrinsics, and the library is built with -fmad=false, so no
// multiply-add is contracted into an FMA (a contracted p = y - floor(y)
// would move p by an ulp and flip u < p).  The results equal the plain
// PyTorch versions (ref.py) bit for bit.
//
// The keyed dither.  Algorithm 1 compresses worker i's message with key
// split(k, n)[i] = threefry2x32(k, (0, i)) and its uniforms
// uniform(split(k, n)[i], (L,)) (repro_torch.random, which is jax.random).
// fused_dither_keyed reads the parent key k (int64 [2], on the device: no
// host synchronisation), derives row i's key and element j's uniform
// uniform_at(row key, j) in registers (threefry.cuh), so neither the keys
// nor the uniforms are ever written to device memory and the int64 tensor
// passes that drew them are gone (710 of the quickstart round's 1,502
// kernels on an NVIDIA H100 80GB HBM3 at 700 W; kernel_timing.py
// quickstart).  A row
// is split over a cluster of C in {8, 4, 2, 1} CTAs (ops.dither_cluster: a
// sibling of fused_topk's rule, with its own minimum share
// DITHER_MIN_SHARE): each CTA reduces the max |x| of its share, the C
// maxima are merged through distributed shared memory, and each CTA then
// quantizes its share.
//
// Bounds on the H100: the u-taking dither moves 12 B an element (x and u
// read, out written) and does a few operations each: memory bounds it.
// The keyed dither must move 8 B an element (x once, out once), but its
// threefry (20 rounds of adds, funnel shifts and xors) takes ~60 integer
// instructions an element, so its bound is its main loop's instructions on
// the busiest pipe, read from the SASS of the library it runs
// (chip_smoke.loop_clocks_per_element): 63 ALU instructions of 115 an
// element, 0.0015 ms at [20, 20000].  Measured there: 0.0100 ms, against
// 0.0149 ms for the u-taking kernel, one CTA a row (NVIDIA H100 80GB HBM3,
// 700 W; chip_smoke.py).  fused_topk reads x and writes out,
// 8 B an element; it finds the k-th largest |x| by a radix select (four
// 8-bit digits of the uint32 pattern, histograms in shared memory), each
// CTA holding its share of the row in shared memory when it fits (one read
// of the row from device memory), and splits the row over a cluster of C
// in {1, 2, 4, 8} CTAs (chosen by the wrapper from n, so that n * C
// approaches the SM count) whose histograms and counts are summed through
// distributed shared memory.
//
// Grouped entries.  A sweep runs G grid points of one federation at once:
// rows [G*n, L], point g owning rows [g*n, (g+1)*n), each point with its own
// parameters, as the Pallas kernels read s, frac and d from refs under vmap.
// grouped_dither_keyed_kernel reads the G parent keys [G, 2] and the levels
// s [G] on the device, and row r = g*n + i uses the key
// threefry2x32(keys[g], (0, i)) (= split(keys[g], n)[i]) and level s[g];
// grouped_topk_kernel keeps ceil(frac[g]*L) of row r; the grouped ledger
// kernels price G points in one launch.  Each is the scalar kernel's body
// with the point's parameters read from device memory, so at G = 1 the
// results are bit-identical to the scalar entries'.
//
// Global row ids.  The cohort and sharded engines compress a subset of a
// federation's rows, each under the key its global worker id gives it:
// split(k, N)[id] = threefry2x32(k, (id >> 32, id & 0xffffffff)), which for
// id < 2^32 is also fold_in(k, id).  grouped_dither_keyed_kernel takes an
// optional int64 id vector, [n] shared by the G points (ids_stride 0) or
// [G, n] (ids_stride n), and row i of point g takes its counter from
// ids[g * ids_stride + i] instead of i: one load a row.  Without ids the
// kernel is the one above, bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../csrc/threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;

// ceil(log2(t)) exactly for t > 1: the bit length of ceil(t) - 1.  log2f is
// not correctly rounded, so ceilf(log2f(128)) may give 8; integers do not.
// t <= 1 (and NaN) keeps the float expression of the reference.
__device__ __forceinline__ float ceil_log2(float t) {
  if (!(t > 1.0f) || t > 4.0e18f) return ceilf(log2f(t));
  const unsigned long long v = (unsigned long long)ceilf(t) - 1ull;
  return (float)(64 - __clzll((long long)v));
}

// spec_bits' dither branch: ceil(log2(2s+1)) bits a value, times d values.
__device__ __forceinline__ float dither_bits_f(float s, float d) {
  return __fmul_rn(ceil_log2(__fadd_rn(__fmul_rn(2.0f, s), 1.0f)), d);
}

// spec_bits' top-k branch: clip(ceil(frac*d), 1, d) kept values, each a
// 32-bit payload plus a ceil(log2 d)-bit index.
__device__ __forceinline__ float topk_bits_f(float frac, float d) {
  const float kept = fminf(fmaxf(ceilf(__fmul_rn(frac, d)), 1.0f), d);
  return __fmul_rn(kept, __fadd_rn(32.0f, ceil_log2(fmaxf(d, 1.0f))));
}

// max that propagates NaN like jnp.max (fmaxf drops it).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Block-wide reductions; every thread gets the result.  blockDim.x is a
// multiple of 32.  red[] holds one partial per warp.
__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = nan_max(r, red[w]);
  __syncthreads();
  return r;
}

__device__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) r += red[w];
  __syncthreads();
  return r;
}

// One element of the stochastic rounding, the reference's expressions in
// its order: sign(x) * (floor(|x|/norm*s) + [u < frac]) * norm / s.
__device__ __forceinline__ float dither_value(float xv, float u, float norm,
                                              float s) {
  const float y = __fmul_rn(__fdiv_rn(fabsf(xv), norm), s);  // in [0, s]
  const float lo = floorf(y);
  const float p = __fsub_rn(y, lo);                          // P(round up)
  const float level = __fadd_rn(lo, u < p ? 1.0f : 0.0f);
  // jnp.sign: +-1, and x itself for +-0 and NaN
  const float sg = xv > 0.0f ? 1.0f : (xv < 0.0f ? -1.0f : xv);
  return __fdiv_rn(__fmul_rn(__fmul_rn(sg, level), norm), s);
}

// One CTA per row: the NaN-propagating infinity norm (0 -> 1), then the
// stochastic rounding with the uniforms u read from device memory.
__global__ void __launch_bounds__(kMaxThreads)
fused_dither_kernel(const float* __restrict__ x, const float* __restrict__ u,
                    float s, float* __restrict__ out,
                    float* __restrict__ bits, int L) {
  __shared__ float red[32];
  const size_t off = (size_t)blockIdx.x * (size_t)L;
  const float* xr = x + off;
  const float* ur = u + off;
  float* outr = out + off;

  float m = 0.0f;
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    m = nan_max(m, fabsf(xr[i]));
  m = block_max(m, red);
  const float norm = (m == 0.0f) ? 1.0f : m;

  for (int i = threadIdx.x; i < L; i += blockDim.x)
    outr[i] = dither_value(xr[i], ur[i], norm, s);
  if (threadIdx.x == 0) bits[blockIdx.x] = dither_bits_f(s, (float)L);
}

// A cluster of C CTAs per row (blockIdx.x / C), CTA r holding elements
// [r * share, (r + 1) * share): the row's key threefry2x32(key, (0, row))
// (= split(key, n)[row]), the NaN-propagating infinity norm of the row
// (each CTA's share reduced, the C maxima merged through distributed shared
// memory; 0 -> 1), then each element's uniform uniform_at(row key, j) and
// its stochastic rounding.  kGrouped: row r belongs to point g = r / n_group
// and is that point's row i = r % n_group, with key threefry2x32(keys[g],
// (0, i)) and level s_group[g].
template <bool kGrouped>
__device__ __forceinline__ void dither_keyed_rows(
    const float* __restrict__ x, const long long* __restrict__ key,
    float s_scalar, const float* __restrict__ s_group,
    float* __restrict__ out, float* __restrict__ bits, int L, int share,
    unsigned n_group, const long long* __restrict__ ids,
    unsigned ids_stride) {
  __shared__ float red[32];
  __shared__ float share_max;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks(), rank = cluster.block_rank();
  const unsigned row = blockIdx.x / C;
  const unsigned g = kGrouped ? row / n_group : 0u;
  const unsigned i_row = kGrouped ? row - g * n_group : row;
  const float s = kGrouped ? s_group[g] : s_scalar;
  const int lo = (int)min((long long)rank * share, (long long)L);
  const int m = (int)min((long long)share, (long long)(L - lo));
  const float* xr = x + row * (size_t)L + lo;
  float* outr = out + row * (size_t)L + lo;

  uint32_t rk0 = 0u, rk1 = i_row;
  if (kGrouped && ids != nullptr) {
    const unsigned long long id = static_cast<unsigned long long>(
        ids[(size_t)g * ids_stride + i_row]);
    rk0 = static_cast<uint32_t>(id >> 32);
    rk1 = static_cast<uint32_t>(id);
  }
  repro_threefry::threefry2x32(static_cast<uint32_t>(key[2 * g]),
                               static_cast<uint32_t>(key[2 * g + 1]), rk0,
                               rk1);

  float mx = 0.0f;
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    mx = nan_max(mx, fabsf(xr[i]));
  mx = block_max(mx, red);
  if (threadIdx.x == 0) share_max = mx;
  cluster.sync();                  // every CTA's share maximum is written
  float norm = 0.0f;
  for (unsigned r = 0; r < C; ++r)
    norm = nan_max(norm, *cluster.map_shared_rank(&share_max, r));
  cluster.sync();   // no CTA leaves while another still reads its maximum
  if (norm == 0.0f) norm = 1.0f;

#pragma unroll 4
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float u = repro_threefry::uniform_at(
        rk0, rk1, static_cast<unsigned long long>(static_cast<unsigned>(
                      lo + i)));
    outr[i] = dither_value(xr[i], u, norm, s);
  }
  if (rank == 0 && threadIdx.x == 0) bits[row] = dither_bits_f(s, (float)L);
}

__global__ void __launch_bounds__(kMaxThreads)
fused_dither_keyed_kernel(const float* __restrict__ x,
                          const long long* __restrict__ key, float s,
                          float* __restrict__ out, float* __restrict__ bits,
                          int L, int share) {
  dither_keyed_rows<false>(x, key, s, nullptr, out, bits, L, share, 0u,
                           nullptr, 0u);
}

__global__ void __launch_bounds__(kMaxThreads)
grouped_dither_keyed_kernel(const float* __restrict__ x,
                            const long long* __restrict__ keys,
                            const float* __restrict__ s,
                            float* __restrict__ out,
                            float* __restrict__ bits, int L, int share,
                            unsigned n_group,
                            const long long* __restrict__ ids,
                            unsigned ids_stride) {
  dither_keyed_rows<true>(x, keys, 0.0f, s, out, bits, L, share, n_group,
                          ids, ids_stride);
}

constexpr int kTopkThreads = 512;
// Floats of a row's share that a CTA holds in shared memory; a longer share
// is read from device memory on every pass instead.
constexpr int kTopkMaxStaged = 48 * 1024;

// A cluster of C CTAs per row (blockIdx.x / C), CTA r holding elements
// [r * share, (r + 1) * share): keep the k = clip(ceil(frac*L), 1, L) largest
// |x| of the row with the lowest-index ties, zero the rest.
//
// The k-th largest magnitude is found by a radix select on
// bitcast(|x|, uint32), which orders non-negative floats (and puts NaN above
// inf), as the reference's sort does: four passes over 8-bit digits, most
// significant first; each pass counts the digits of the elements that match
// the digits fixed so far into a shared histogram (integer atomics: exact,
// and faster here than first merging a warp's equal digits), the C
// histograms are summed through distributed shared memory, and every CTA
// fixes the same digit, the one where the count from the top reaches k.
// Then each CTA counts its elements above the threshold and equal to it; a
// tie's rank in row order is its rank within its CTA (tile by tile, with
// warp ballots) plus the ties of the CTAs before it in the cluster.
// kStaged: the share sits in shared memory (one read of the row); else
// every pass streams it from device memory (six reads instead of the 33 of
// a bit-by-bit search).  kGrouped: row r keeps ceil(frac_group[r / n_group]
// * L) values.
template <bool kStaged, bool kGrouped>
__device__ __forceinline__ void topk_rows(const float* __restrict__ x,
                                          float frac_scalar,
                                          const float* __restrict__ frac_group,
                                          float* __restrict__ out,
                                          float* __restrict__ bits, int L,
                                          int share, unsigned n_group) {
  extern __shared__ float staged[];
  __shared__ unsigned hist[4][256];
  __shared__ unsigned tot[256];
  __shared__ unsigned pick[2];
  __shared__ int red[32];
  __shared__ int warp_ties[32];
  __shared__ int counts[2];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned C = cluster.num_blocks(), rank = cluster.block_rank();
  const size_t row = blockIdx.x / C;
  const float frac =
      kGrouped ? frac_group[(unsigned)row / n_group] : frac_scalar;
  const int lo = (int)min((long long)rank * share, (long long)L);
  const int m = (int)min((long long)share, (long long)(L - lo));
  const float* xr = x + row * (size_t)L + lo;
  float* outr = out + row * (size_t)L + lo;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < 4 * 256; i += blockDim.x)
    hist[i / 256][i % 256] = 0;
  if (kStaged)
    for (int i = threadIdx.x; i < m; i += blockDim.x) staged[i] = xr[i];
  __syncthreads();
  auto value = [&](int i) { return kStaged ? staged[i] : xr[i]; };

  int k = (int)ceilf(__fmul_rn(frac, (float)L));
  k = min(max(k, 1), L);

  unsigned want = (unsigned)k;   // rank from the top among the matches
  unsigned prefix = 0, mask = 0;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const unsigned p = __float_as_uint(fabsf(value(i)));
      if ((p & mask) == prefix)
        atomicAdd(&hist[pass][(p >> shift) & 255u], 1u);
    }
    cluster.sync();   // every CTA's histogram of this pass is complete
    for (int d = threadIdx.x; d < 256; d += blockDim.x) {
      unsigned sum = 0;
      for (unsigned r = 0; r < C; ++r)
        sum += cluster.map_shared_rank(&hist[pass][0], r)[d];
      tot[d] = sum;
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds digits 255 - 8l down to 248 - 8l; the count above its
      // digits is an exclusive scan over the lanes
      unsigned mine = 0;
      for (int j = 0; j < 8; ++j) mine += tot[255 - 8 * lane - j];
      unsigned incl = mine;
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      unsigned above = incl - mine;
      if (above < want && want <= incl) {
        for (int j = 0; j < 8; ++j) {
          const unsigned d = 255 - 8 * lane - j;
          if (above + tot[d] >= want) {
            pick[0] = d;
            pick[1] = above;
            break;
          }
          above += tot[d];
        }
      }
    }
    __syncthreads();
    want -= pick[1];
    prefix |= pick[0] << shift;
    mask |= 255u << shift;
  }
  const float thresh = __uint_as_float(prefix);   // the k-th largest |x|

  int n_above = 0, n_ties = 0;
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    const float ax = fabsf(value(i));
    n_above += ax > thresh;
    n_ties += ax == thresh;
  }
  n_above = block_sum(n_above, red);
  n_ties = block_sum(n_ties, red);
  if (threadIdx.x == 0) {
    counts[0] = n_above;
    counts[1] = n_ties;
  }
  cluster.sync();
  int total_above = 0, seen = 0;               // seen: ties in earlier CTAs
  for (unsigned r = 0; r < C; ++r) {
    const int* rc = cluster.map_shared_rank(counts, r);
    total_above += rc[0];
    if (r < rank) seen += rc[1];
  }
  cluster.sync();   // no CTA leaves while another still reads its counts
  const int budget = k - total_above;          // ties that may still be kept

  const int n_warps = blockDim.x >> 5;
  for (int tile = 0; tile < m; tile += blockDim.x) {
    const int i = tile + threadIdx.x;
    const float xv = i < m ? value(i) : 0.0f;
    const float ax = fabsf(xv);
    const bool tie = i < m && ax == thresh;
    const unsigned ballot = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) warp_ties[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < n_warps; ++w) {
      before += w < warp ? warp_ties[w] : 0;
      total += warp_ties[w];
    }
    // 1-based rank of this tie in row order
    const int r = seen + before + __popc(ballot & ((1u << lane) - 1u)) + 1;
    if (i < m) outr[i] = (ax > thresh || (tie && r <= budget)) ? xv : 0.0f;
    seen += total;
    __syncthreads();
  }
  if (rank == 0 && threadIdx.x == 0) bits[row] = topk_bits_f(frac, (float)L);
}

template <bool kStaged>
__global__ void __launch_bounds__(kTopkThreads)
fused_topk_kernel(const float* __restrict__ x, float frac,
                  float* __restrict__ out, float* __restrict__ bits, int L,
                  int share) {
  topk_rows<kStaged, false>(x, frac, nullptr, out, bits, L, share, 0u);
}

__global__ void dither_bits_kernel(float s, float d, float* out) {
  *out = dither_bits_f(s, d);
}

__global__ void topk_bits_kernel(float frac, float d, float* out) {
  *out = topk_bits_f(frac, d);
}

// One thread a grid point.
__global__ void grouped_dither_bits_kernel(const float* __restrict__ s,
                                           float d, float* __restrict__ out,
                                           int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) out[g] = dither_bits_f(s[g], d);
}

__global__ void grouped_topk_bits_kernel(const float* __restrict__ frac,
                                         float d, float* __restrict__ out,
                                         int G) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g < G) out[g] = topk_bits_f(frac[g], d);
}

int threads_for(int L) {
  const int t = ((L + 31) / 32) * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace

// C entry points (loaded with ctypes).  Each launches on the given stream,
// allocates nothing, does not synchronise, and returns cudaGetLastError().

extern "C" int repro_fused_dither(const float* x, const float* u, float s,
                                  float* out, float* bits, int n, int L,
                                  void* stream) {
  fused_dither_kernel<<<n, threads_for(L), 0, (cudaStream_t)stream>>>(
      x, u, s, out, bits, L);
  return (int)cudaGetLastError();
}

namespace {

// A launch of C CTAs a row over n rows, as a cluster of C.
cudaLaunchConfig_t cluster_config(int n, int cluster, int threads,
                                  size_t smem, void* stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n * (unsigned)cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool valid_cluster(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

}  // namespace

// key: int64 [2] on the device (repro_torch.random's key data); cluster:
// CTAs a row, 1, 2, 4 or 8 (a cluster of that size).
extern "C" int repro_fused_dither_keyed(const float* x, const long long* key,
                                        float s, float* out, float* bits,
                                        int n, int L, int cluster,
                                        void* stream) {
  if (!valid_cluster(cluster) || key == nullptr)
    return (int)cudaErrorInvalidValue;
  const int share = (int)((L + (long long)cluster - 1) / cluster);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(n, cluster, threads_for(share), 0,
                                          stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, fused_dither_keyed_kernel, x, key, s, out, bits, L, share);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

namespace {

// Launch top-k over rows of L, C CTAs a row: the staged instance when a
// share fits in shared memory, else the streaming one.
template <typename Staged, typename Streamed, typename... Args>
int launch_topk(Staged staged_kernel, Streamed streamed_kernel, int rows,
                int L, int cluster, void* stream, Args... args) {
  if (!valid_cluster(cluster)) return (int)cudaErrorInvalidValue;
  const int share = (int)((L + (long long)cluster - 1) / cluster);
  const bool staged = share <= kTopkMaxStaged;
  const size_t bytes = staged ? (size_t)share * sizeof(float) : 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(rows, cluster, kTopkThreads, bytes,
                                          stream, &attr);
  cudaError_t err;
  if (staged) {
    // above 48 KB a launch is refused unless the kernel is allowed more
    err = cudaFuncSetAttribute(staged_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err == cudaSuccess)
      err = cudaLaunchKernelEx(&cfg, staged_kernel, args..., L, share);
  } else {
    err = cudaLaunchKernelEx(&cfg, streamed_kernel, args..., L, share);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// cluster: CTAs a row, 1, 2, 4 or 8 (a cluster of that size).
extern "C" int repro_fused_topk(const float* x, float frac, float* out,
                                float* bits, int n, int L, int cluster,
                                void* stream) {
  return launch_topk(fused_topk_kernel<true>, fused_topk_kernel<false>, n, L,
                     cluster, stream, x, frac, out, bits);
}

extern "C" int repro_dither_bits(float s, float d, float* out,
                                 void* stream) {
  dither_bits_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(s, d, out);
  return (int)cudaGetLastError();
}

extern "C" int repro_topk_bits(float frac, float d, float* out,
                               void* stream) {
  topk_bits_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(frac, d, out);
  return (int)cudaGetLastError();
}

// Grouped entries: rows = G * n_group rows of L, point g owning rows
// [g * n_group, (g + 1) * n_group); keys int64 [G, 2], s and frac float32
// [G], all on the device.  ids: null, or the rows' global ids (int64, [n]
// with ids_stride 0 or [G, n] with ids_stride n_group) on the device.
extern "C" int repro_fused_dither_keyed_grouped(const float* x,
                                                const long long* keys,
                                                const float* s, float* out,
                                                float* bits, int rows, int L,
                                                int n_group, int cluster,
                                                const long long* ids,
                                                int ids_stride,
                                                void* stream) {
  if (!valid_cluster(cluster) || keys == nullptr || s == nullptr ||
      n_group < 1 || rows % n_group ||
      (ids_stride != 0 && ids_stride != n_group))
    return (int)cudaErrorInvalidValue;
  const int share = (int)((L + (long long)cluster - 1) / cluster);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(rows, cluster, threads_for(share),
                                          0, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, grouped_dither_keyed_kernel, x, keys, s, out, bits, L, share,
      (unsigned)n_group, ids, (unsigned)ids_stride);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

namespace {

template <bool kStaged>
__global__ void __launch_bounds__(kTopkThreads)
grouped_topk_kernel(const float* __restrict__ x,
                    const float* __restrict__ frac, float* __restrict__ out,
                    float* __restrict__ bits, unsigned n_group, int L,
                    int share) {
  topk_rows<kStaged, true>(x, 0.0f, frac, out, bits, L, share, n_group);
}

}  // namespace

extern "C" int repro_fused_topk_grouped(const float* x, const float* frac,
                                        float* out, float* bits, int rows,
                                        int L, int n_group, int cluster,
                                        void* stream) {
  if (frac == nullptr || n_group < 1 || rows % n_group)
    return (int)cudaErrorInvalidValue;
  return launch_topk(grouped_topk_kernel<true>, grouped_topk_kernel<false>,
                     rows, L, cluster, stream, x, frac, out, bits,
                     (unsigned)n_group);
}

extern "C" int repro_dither_bits_grouped(const float* s, float d, float* out,
                                         int G, void* stream) {
  grouped_dither_bits_kernel<<<(G + 255) / 256, 256, 0,
                               (cudaStream_t)stream>>>(s, d, out, G);
  return (int)cudaGetLastError();
}

extern "C" int repro_topk_bits_grouped(const float* frac, float d,
                                       float* out, int G, void* stream) {
  grouped_topk_bits_kernel<<<(G + 255) / 256, 256, 0,
                             (cudaStream_t)stream>>>(frac, d, out, G);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fused_topk, the grid-wide instance (rows too long for one cluster).
//
// The cluster instance above puts at most 8 CTAs on a row, so a few long
// rows leave most SMs idle (20 rows of 25,000,000: 80 CTAs of 132 SMs) and
// its streamed shares are read from device memory six times.  Here, in the
// manner of AIR top-k (Zhang et al., SC'23), every CTA owns a fixed chunk of
// one row (the grid is chunks x rows: ~15,000 CTAs at [20, 25e6]), and the
// radix select runs over the whole grid, one kernel a digit:
//   pass 0  histograms digit 0 (bits 31-21 of bitcast(|x|): the exponent and
//           the top two mantissa bits) of its chunk in shared memory, and
//           counts the NaNs;
//   pass 1  histograms digit 1 (bits 20-10) of the elements whose digit 0 is
//           the chosen one, and appends those elements' bit patterns to the
//           row's candidate buffer when they fit (their count is pass 0's
//           chosen bin, known before the pass: a deterministic choice);
//   pass 2  histograms digit 2 (bits 9-0) over the candidates, or over x
//           again when they did not fit;
// each CTA adds its histogram into the row's histogram in device memory
// with integer atomics (exact in any order), and the last CTA of the row
// (an atomic ticket after a __threadfence) picks the digit and the rank
// that remains, so the host reads nothing between passes.  After pass 2
// the row's threshold, the count above it and its ties are known.  The
// keep rule is the reference's, in float compares: |x| > thresh (a NaN
// threshold keeps nothing; NaNs sort above inf but are never "above"),
// plus the lowest-index ties up to budget = k - above.  A row whose ties
// all fit keeps them all; otherwise a counting pass writes each chunk's
// ties, and a chunk sums the counts of the chunks before it, so only the
// chunk where the budget runs out ranks its ties (tile by tile, with a
// block scan).  Then one pass writes the output.
//
// Bytes: x is read three times (passes 0 and 1 and the output pass; pass 2
// reads the candidates) and out written once, ~16 B an element, against
// the 8 B of the bound.  Chunks: a power of two from 4,096 to 32,768
// elements, the smallest that keeps the grid within 8 CTAs an SM
// (ops.topk_chunk); timed at 4,096-32,768 at every shape of
// chip_smoke.TOPK_TIMED: 4,096 is best up to [1, 3e6] (0.041 ms; 32,768:
// 0.069), 32,768 at [20, 25e6] (3.40 ms; 4,096: 4.82) and [60, 25e6]
// (10.02; 14.43) (kernel_timing.py topk --topk-chunk; NVIDIA H100 80GB
// HBM3, 700 W).  Loads and stores are 16 bytes a thread from the
// first 16-byte aligned element of the row on (rows of odd L start
// unaligned: chunk 0 takes the head, the last chunk the tail).  The
// wrapper allocates the workspace (histograms, the row's state, the chunk
// tie counts: zeroed) and the candidate buffer (L / 8 words a row).
// ---------------------------------------------------------------------------

namespace {

constexpr int kGridThreads = 256;
// Workspace words a row: the three histograms, the state, then one tie
// count a chunk (ops.TOPK_GRID_WS_WORDS mirrors kChunkTies).
constexpr int kStateOff = 5120;   // after histograms of 2048, 2048, 1024
enum : int {
  kTicket = 0,        // three tickets, one a pass
  kNan = 3,           // NaNs of the row
  kCandCount = 4,     // candidates appended so far
  kWant = 5,          // rank still sought among the matches
  kPrefix = 6,        // digits fixed so far (the threshold at the end)
  kAbove = 7,         // elements whose pattern is above the prefix
  kMatch = 8,         // elements matching digit 0 (pass 0's chosen bin)
  kTies = 9,          // ties of the threshold (float compare)
  kK = 10,            // k
  kBudget = 11,       // ties that may still be kept: k - above
  kMode = 12,         // 1: the ties do not all fit, rank them
  kStateWords = 16
};
constexpr int kChunkTies = kStateOff + kStateWords;

__device__ __forceinline__ int topk_k(float frac, int L) {
  int k = (int)ceilf(__fmul_rn(frac, (float)L));
  return min(max(k, 1), L);
}

// Chunk c of a row of L (xr, its first element), in row order, a tile at a
// time: every thread calls f(n, e, v) once a tile, holding the n (0..4)
// consecutive elements v[0..n) that start at element e.  The vector part
// starts at the row's first 16-byte aligned element (`head` elements in),
// chunk 0 also takes the head and chunk nc - 1 the tail (< 4 elements).
// The trip count is the same for every thread of the block, so f may
// synchronise the block.
template <typename F>
__device__ __forceinline__ void chunk_tiles(const float* __restrict__ xr,
                                            int L, int c, int nc,
                                            int chunk, F&& f) {
  const int head = min(
      (int)(((16u - (unsigned)(reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u)
            >> 2), L);
  const int vend = head + ((L - head) & ~3);
  float v[4];
  if (c == 0 && head > 0) {
    const int e = threadIdx.x;
    const int n = e < head ? 1 : 0;
    if (n) v[0] = xr[e];
    f(n, e, v);
  }
  const int lo = (int)min((long long)head + (long long)c * chunk,
                          (long long)vend);
  const int hi = (int)min((long long)lo + chunk, (long long)vend);
  // two tiles an iteration, both loads issued before either is used
  for (int b = lo; b < hi; b += 8 * kGridThreads) {
    const int e0 = b + 4 * threadIdx.x, e1 = e0 + 4 * kGridThreads;
    float4 q0 = {}, q1 = {};
    if (e0 < hi) q0 = *reinterpret_cast<const float4*>(xr + e0);
    if (e1 < hi) q1 = *reinterpret_cast<const float4*>(xr + e1);
    v[0] = q0.x;
    v[1] = q0.y;
    v[2] = q0.z;
    v[3] = q0.w;
    f(e0 < hi ? 4 : 0, e0, v);
    v[0] = q1.x;
    v[1] = q1.y;
    v[2] = q1.z;
    v[3] = q1.w;
    f(e1 < hi ? 4 : 0, e1, v);
  }
  if (c == nc - 1 && vend < L) {
    const int e = vend + threadIdx.x;
    const int n = e < L ? 1 : 0;
    if (n) v[0] = xr[e];
    f(n, e, v);
  }
}

// Block-wide exclusive scan of v (threads in order); *total gets the sum.
// red holds one partial a warp.
__device__ __forceinline__ unsigned block_scan(unsigned v, unsigned* red,
                                               unsigned* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += up;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  unsigned before = 0, sum = 0;
  for (int w = 0; w < kGridThreads / 32; ++w) {
    before += w < warp ? red[w] : 0u;
    sum += red[w];
  }
  __syncthreads();
  *total = sum;
  return before + incl - v;
}

// Count one digit into the shared histogram (key ~0u: no element).  Pass 0
// puts most elements of Gaussian-like rows into a few bins, yet merging a
// warp's equal digits first (__match_any_sync, one atomic a distinct digit)
// was slower than these plain shared-memory atomics: 5.10 against 3.49 ms
// at [20, 25e6], 14.69 against 9.91 at [60, 25e6] (kernel_timing.py
// compressor, one call, 32,768-element chunks; NVIDIA H100 80GB HBM3,
// 700 W).  That variant is not in this source (PERF.md keeps its times).
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned key) {
  if (key != ~0u) atomicAdd(&hist[key], 1u);
}

// The last CTA of a row: the digit where the count from the top of the
// row's histogram gh (kBins bins, in device memory) reaches want.
// out: digit, count above it, count in it.
template <int kBins>
__device__ __forceinline__ void pick_digit(const unsigned* gh, unsigned want,
                                           unsigned* out, unsigned* red) {
  constexpr int P = kBins / kGridThreads;
  const int top = kBins - 1 - P * (int)threadIdx.x;
  unsigned v[P], mine = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    v[j] = __ldcg(gh + top - j);
    mine += v[j];
  }
  unsigned total;
  unsigned above = block_scan(mine, red, &total);
  if (above < want && want <= above + mine) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (above + v[j] >= want) {
        out[0] = (unsigned)(top - j);
        out[1] = above;
        out[2] = v[j];
        break;
      }
      above += v[j];
    }
  }
  __syncthreads();
}

// One radix pass of the grid-wide select (design above); grid (nc, rows).
template <int kPass>
__global__ void __launch_bounds__(kGridThreads)
topk_grid_hist_kernel(const float* __restrict__ x, float frac_scalar,
                      const float* __restrict__ frac_group,
                      unsigned* __restrict__ ws, unsigned* __restrict__ cand,
                      int L, int chunk, int ws_stride, int cap,
                      unsigned n_group) {
  constexpr int kShift = kPass == 0 ? 21 : (kPass == 1 ? 10 : 0);
  constexpr int kBins = kPass == 2 ? 1024 : 2048;
  constexpr unsigned kFixed =
      kPass == 0 ? 0u : (kPass == 1 ? 0xffe00000u : 0xfffffc00u);
  __shared__ unsigned hist[kBins];
  __shared__ unsigned red[32];
  __shared__ unsigned pick[3];
  __shared__ unsigned s_base, s_last;
  const unsigned row = blockIdx.y;
  const int c = blockIdx.x, nc = gridDim.x;
  unsigned* w = ws + (size_t)row * ws_stride;
  unsigned* st = w + kStateOff;
  const float* xr = x + (size_t)row * L;
  unsigned* cr = cand + (size_t)row * cap;
  for (int i = threadIdx.x; i < kBins; i += kGridThreads) hist[i] = 0;
  __syncthreads();
  const unsigned prefix = kPass ? st[kPrefix] : 0u;
  const bool fits = kPass && st[kMatch] <= (unsigned)cap;
  unsigned nan = 0;

  if (kPass == 2 && fits) {
    // the candidates, split evenly over the row's CTAs
    const int n = (int)st[kMatch];
    const int per = (n + nc - 1) / nc;
    const int lo = min(c * per, n), hi = min(lo + per, n);
    for (int b = lo; b < hi; b += kGridThreads) {
      const int i = b + threadIdx.x;
      const unsigned p = i < hi ? cr[i] : 0u;
      hist_add(hist, i < hi && (p & kFixed) == prefix ? (p & 1023u) : ~0u);
    }
  } else {
    chunk_tiles(xr, L, c, nc, chunk, [&](int n, int, const float* v) {
      unsigned p[4];
      int m = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[j] = j < n ? (__float_as_uint(v[j]) & 0x7fffffffu) : 0u;
        const bool match = j < n && (p[j] & kFixed) == prefix;
        if (kPass == 0) nan += j < n && p[j] > 0x7f800000u;
        hist_add(hist, match ? ((p[j] >> kShift) & (kBins - 1)) : ~0u);
        m += match;
      }
      if (kPass == 1 && fits) {          // append the matches, in a block
        unsigned total;
        const unsigned off = block_scan((unsigned)m, red, &total);
        if (threadIdx.x == 0 && total)
          s_base = atomicAdd(&st[kCandCount], total);
        __syncthreads();
        unsigned at = s_base + off;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < n && (p[j] & kFixed) == prefix) cr[at++] = p[j];
        __syncthreads();                 // s_base is read before reuse
      }
    });
  }
  __syncthreads();
  unsigned* gh = w + (kPass == 0 ? 0 : (kPass == 1 ? 2048 : 4096));
  for (int i = threadIdx.x; i < kBins; i += kGridThreads)
    if (hist[i]) atomicAdd(&gh[i], hist[i]);
  if (kPass == 0) {
    unsigned total;
    block_scan(nan, red, &total);
    if (threadIdx.x == 0 && total) atomicAdd(&st[kNan], total);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&st[kTicket + kPass], 1u) == (unsigned)nc - 1u;
  __syncthreads();
  if (!s_last) return;
  __threadfence();          // every CTA's histogram of the row has landed

  const float frac = frac_group ? frac_group[row / n_group] : frac_scalar;
  const int k = topk_k(frac, L);
  const unsigned want = kPass ? __ldcg(st + kWant) : (unsigned)k;
  pick_digit<kBins>(gh, want, pick, red);
  if (threadIdx.x == 0) {
    const unsigned d = pick[0], above = pick[1], count = pick[2];
    const unsigned pre = prefix | (d << kShift);
    const unsigned above_all = (kPass ? __ldcg(st + kAbove) : 0u) + above;
    st[kPrefix] = pre;
    st[kAbove] = above_all;
    st[kWant] = want - above;
    if (kPass == 0) {
      st[kMatch] = count;
      st[kK] = (unsigned)k;
    }
    if (kPass == 2) {
      // pre is the k-th largest pattern; the reference compares floats
      const bool nan_th = pre > 0x7f800000u;
      const unsigned n_above = nan_th ? 0u : above_all - __ldcg(st + kNan);
      const unsigned n_ties = nan_th ? 0u : count;
      const unsigned budget = (unsigned)k - n_above;
      st[kTies] = n_ties;
      st[kBudget] = budget;
      st[kMode] = n_ties > budget ? 1u : 0u;
    }
  }
}

// Rows that rank their ties: each chunk's count of |x| == thresh.
__global__ void __launch_bounds__(kGridThreads)
topk_grid_ties_kernel(const float* __restrict__ x, unsigned* __restrict__ ws,
                      int L, int chunk, int ws_stride) {
  __shared__ unsigned red[32];
  const unsigned row = blockIdx.y;
  const int c = blockIdx.x, nc = gridDim.x;
  unsigned* w = ws + (size_t)row * ws_stride;
  if (w[kStateOff + kMode] == 0u) return;
  const float th = __uint_as_float(w[kStateOff + kPrefix]);
  unsigned ties = 0;
  chunk_tiles(x + (size_t)row * L, L, c, nc, chunk,
              [&](int n, int, const float* v) {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  ties += j < n && fabsf(v[j]) == th;
              });
  unsigned total;
  block_scan(ties, red, &total);
  if (threadIdx.x == 0) w[kChunkTies + c] = total;
}

// The output: everything above the threshold and the ties the budget
// keeps, the lowest-index first; the row's payload bits.
__global__ void __launch_bounds__(kGridThreads)
topk_grid_out_kernel(const float* __restrict__ x, float frac_scalar,
                     const float* __restrict__ frac_group,
                     const unsigned* __restrict__ ws, float* __restrict__ out,
                     float* __restrict__ bits, int L, int chunk,
                     int ws_stride, unsigned n_group) {
  __shared__ unsigned red[32];
  const unsigned row = blockIdx.y;
  const int c = blockIdx.x, nc = gridDim.x;
  const unsigned* w = ws + (size_t)row * ws_stride;
  const unsigned* st = w + kStateOff;
  const float th = __uint_as_float(st[kPrefix]);
  const unsigned budget = st[kBudget];
  const float* xr = x + (size_t)row * L;
  float* outr = out + (size_t)row * L;
  // 16-byte stores where out's row has x's alignment
  const bool vec_out = ((reinterpret_cast<uintptr_t>(outr)
                         - reinterpret_cast<uintptr_t>(xr)) & 15u) == 0;
  bool keep_ties = true, rank = false;
  unsigned seen = 0;                     // ties of the chunks before this
  if (st[kMode]) {
    unsigned part = 0;
    for (int i = threadIdx.x; i < c; i += kGridThreads)
      part += w[kChunkTies + i];
    unsigned total;
    block_scan(part, red, &total);
    seen = total;
    const unsigned mine = w[kChunkTies + c];
    keep_ties = seen + mine <= budget;
    rank = seen < budget && !keep_ties;
  }
  chunk_tiles(xr, L, c, nc, chunk, [&](int n, int e, const float* v) {
    bool keep[4];
    unsigned t = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float ax = fabsf(v[j]);
      keep[j] = j < n && (ax > th || (keep_ties && ax == th));
      t += j < n && ax == th;
    }
    if (rank) {                          // block-uniform
      unsigned total;
      unsigned r = seen + block_scan(t, red, &total);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < n && fabsf(v[j]) == th) keep[j] = ++r <= budget;
      seen += total;
    }
    float o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = keep[j] ? v[j] : 0.0f;
    if (n == 4 && vec_out) {
      __stcs(reinterpret_cast<float4*>(outr + e),
             make_float4(o[0], o[1], o[2], o[3]));
    } else {
      for (int j = 0; j < n; ++j) outr[e + j] = o[j];
    }
  });
  if (c == 0 && threadIdx.x == 0) {
    const float frac = frac_group ? frac_group[row / n_group] : frac_scalar;
    bits[row] = topk_bits_f(frac, (float)L);
  }
}

}  // namespace

// The grid-wide instance of both top-k entries: frac_group null keeps
// ceil(frac * L) of every row, else rows [g * n_group, (g + 1) * n_group)
// keep ceil(frac_group[g] * L).  ws: int32 [rows, ws_stride], zeroed,
// ws_stride >= 5136 + ceil(L / chunk); cand: int32 [rows, cap].  Five
// launches: the three radix passes, the tie counts, the output.
extern "C" int repro_fused_topk_grid(const float* x, float frac,
                                     const float* frac_group, float* out,
                                     float* bits, unsigned* ws,
                                     unsigned* cand, int rows, int L,
                                     int n_group, int chunk, int ws_stride,
                                     int cap, void* stream) {
  if (rows < 1 || rows > 65535 || L < 1 || chunk < 4 || chunk % 4
      || n_group < 1 || (frac_group && rows % n_group) || cap < 0)
    return (int)cudaErrorInvalidValue;
  const long long nc = (L + (long long)chunk - 1) / chunk;
  if (ws_stride < kChunkTies + nc) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nc, (unsigned)rows);
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned ng = (unsigned)n_group;
  topk_grid_hist_kernel<0><<<grid, kGridThreads, 0, s>>>(
      x, frac, frac_group, ws, cand, L, chunk, ws_stride, cap, ng);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_grid_hist_kernel<1><<<grid, kGridThreads, 0, s>>>(
      x, frac, frac_group, ws, cand, L, chunk, ws_stride, cap, ng);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  topk_grid_hist_kernel<2><<<grid, kGridThreads, 0, s>>>(
      x, frac, frac_group, ws, cand, L, chunk, ws_stride, cap, ng);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  topk_grid_ties_kernel<<<grid, kGridThreads, 0, s>>>(x, ws, L, chunk,
                                                      ws_stride);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  topk_grid_out_kernel<<<grid, kGridThreads, 0, s>>>(
      x, frac, frac_group, ws, out, bits, L, chunk, ws_stride, ng);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
