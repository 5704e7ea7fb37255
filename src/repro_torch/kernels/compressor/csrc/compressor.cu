// Fused compressor kernels of FLECS-CGD for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/compressor/
// compressor.py:
//   fused_dither_kernel  <- _fused_dither_kernel  (compressor.py:71)
//   fused_topk_kernel    <- _fused_topk_kernel    (compressor.py:105)
//   dither_bits_kernel   <- _dither_bits_kernel   (compressor.py:161)
//   topk_bits_kernel     <- _topk_bits_kernel     (compressor.py:165)
//
// Layout: x is [n, L] float32, row-major and contiguous; one row is one
// worker's whole message (a gradient difference, L = d, or a flattened
// [d, m] Hessian-sketch difference, L = d*m).  The infinity norm and the
// top-k threshold are taken over the whole row.  One CTA handles one row.
//
// Exactness: every kernel evaluates the reference expressions of
// repro.core.compressors in the same order with round-to-nearest
// intrinsics, and the library is built with -fmad=false, so no
// multiply-add is contracted into an FMA (a contracted p = y - floor(y)
// would move p by an ulp and flip u < p).  The results equal the plain
// PyTorch versions (ref.py) bit for bit.
//
// Bounds on the H100: both fused kernels move their bytes once from device
// memory (dither reads x and u and writes out, 12 B per element; top-k
// reads x and writes out, 8 B per element) and do a few operations per
// byte, so memory bounds them.  This first version takes one CTA per row,
// which leaves most of the 132 SMs idle at the path's n = 20 rows, and the
// top-k threshold search re-reads the row (from L2) once per bit.  A
// split-row design over a thread-block cluster, radix select in shared
// memory, and drawing the dither uniforms in registers are later work
// (ROADMAP.md).

#include <cuda_runtime.h>
#include <stdint.h>

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

// One CTA per row: the NaN-propagating infinity norm (0 -> 1), then the
// stochastic rounding sign(x) * (floor(|x|/norm*s) + [u < frac]) * norm / s
// with the uniforms u read from device memory.
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

  for (int i = threadIdx.x; i < L; i += blockDim.x) {
    const float xv = xr[i];
    const float y = __fmul_rn(__fdiv_rn(fabsf(xv), norm), s);  // in [0, s]
    const float lo = floorf(y);
    const float p = __fsub_rn(y, lo);                          // P(round up)
    const float level = __fadd_rn(lo, ur[i] < p ? 1.0f : 0.0f);
    // jnp.sign: +-1, and x itself for +-0 and NaN
    const float sg = xv > 0.0f ? 1.0f : (xv < 0.0f ? -1.0f : xv);
    outr[i] = __fdiv_rn(__fmul_rn(__fmul_rn(sg, level), norm), s);
  }
  if (threadIdx.x == 0) bits[blockIdx.x] = dither_bits_f(s, (float)L);
}

// One CTA per row: keep the k = clip(ceil(frac*L), 1, L) largest |x| with
// the lowest-index ties, zero the rest.  The k-th largest magnitude is found
// without a sort: bitcast(|x|, int32) orders non-negative floats (and puts
// NaN above inf), so a 31-step MSB-first search keeps a candidate bit iff at
// least k patterns still compare >= the candidate.  Ties are then ranked in
// row order, tile by tile, with warp ballots and a scan over the warps.
__global__ void __launch_bounds__(kMaxThreads)
fused_topk_kernel(const float* __restrict__ x, float frac,
                  float* __restrict__ out, float* __restrict__ bits, int L) {
  __shared__ int red[32];
  __shared__ int warp_ties[32];
  const size_t off = (size_t)blockIdx.x * (size_t)L;
  const float* xr = x + off;
  float* outr = out + off;

  int k = (int)ceilf(__fmul_rn(frac, (float)L));
  k = min(max(k, 1), L);

  int pat = 0;
  for (int j = 0; j < 31; ++j) {
    const int cand = pat | (1 << (30 - j));
    int c = 0;
    for (int i = threadIdx.x; i < L; i += blockDim.x)
      c += __float_as_int(fabsf(xr[i])) >= cand;
    if (block_sum(c, red) >= k) pat = cand;
  }
  const float thresh = __int_as_float(pat);

  int c = 0;
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    c += fabsf(xr[i]) > thresh;
  const int budget = k - block_sum(c, red);   // ties that may still be kept

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int seen = 0;                                // ties in earlier tiles
  for (int tile = 0; tile < L; tile += blockDim.x) {
    const int i = tile + threadIdx.x;
    const float xv = i < L ? xr[i] : 0.0f;
    const float ax = fabsf(xv);
    const bool tie = i < L && ax == thresh;
    const unsigned ballot = __ballot_sync(0xffffffffu, tie);
    if (lane == 0) warp_ties[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < n_warps; ++w) {
      before += w < warp ? warp_ties[w] : 0;
      total += warp_ties[w];
    }
    // 1-based rank of this tie in row order
    const int rank = seen + before + __popc(ballot & ((1u << lane) - 1u)) + 1;
    if (i < L) outr[i] = (ax > thresh || (tie && rank <= budget)) ? xv : 0.0f;
    seen += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) bits[blockIdx.x] = topk_bits_f(frac, (float)L);
}

__global__ void dither_bits_kernel(float s, float d, float* out) {
  *out = dither_bits_f(s, d);
}

__global__ void topk_bits_kernel(float frac, float d, float* out) {
  *out = topk_bits_f(frac, d);
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

extern "C" int repro_fused_topk(const float* x, float frac, float* out,
                                float* bits, int n, int L, void* stream) {
  fused_topk_kernel<<<n, threads_for(L), 0, (cudaStream_t)stream>>>(
      x, frac, out, bits, L);
  return (int)cudaGetLastError();
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

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
