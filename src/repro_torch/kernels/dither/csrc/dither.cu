// Random-dithering int8 codec for Hopper (sm_90a): encode and decode.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dither/dither.py:
// `_encode_kernel` (:25, called by `dither_encode`) and `_decode_kernel`
// (:62, called by `dither_decode`).
//   encode: for each block of `block_rows` rows of x [R, C], norm = max |x|
//           over the block (0 -> 1), y = x / norm * s, lo = floor(y),
//           level = lo + (u < y - lo) as int8, and scale = norm / s;
//   decode: out = float(level) * scale[block].
//
// Bit identity with the plain version (kernels/dither/ref.py) and the
// reference: the expressions are evaluated in the reference's order with
// round-to-nearest intrinsics, the library is built with -fmad=false, and
// the int8 conversion is XLA's: NaN -> 0, then saturation to [-128, 127]
// (levels pass 127 whenever s > 127; a C cast of an out-of-range float is
// undefined, and torch's .to(int8) wraps).
//
// Design.  The TPU kernel keeps one block resident in VMEM and sweeps it a
// second time for free.  On Hopper a block can be a whole gradient leaf (the
// FLECS-CGD trainer quantizes each parameter tensor as one block: up to
// 254 M elements for the stacked FFN weights), far beyond shared memory, so
// the encode is two passes over a grid of (block, chunk of CHUNK elements):
//   1. each CTA reduces |x| over its chunk and merges it into its block's
//      maximum with atomicMax on the uint32 bits of |x|: exact and
//      independent of order for non-negative floats; a NaN's sign-cleared
//      bits sort above +inf, so a NaN propagates as jnp.max propagates it;
//   2. each CTA reads its block's norm and writes its chunk's levels; the
//      CTA of chunk 0 writes the block's scale.
// A small block (the 8 x 512 default of `quantize`) is one chunk: one CTA
// per block in each pass.
//
// What bounds it on this card: bytes.  The encode must read x and u and
// write the levels, 9 B an element for float32 x (7 B for bfloat16); this
// version reads x twice (13 B), because a block does not fit on chip.  The
// decode reads 1 B and writes 4 B an element, with 16-byte vector loads of
// the levels and 16-byte stores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 16;
constexpr long long CHUNK = THREADS * PER_THREAD;   // elements per CTA

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// XLA's float -> int8 conversion: NaN -> 0, saturating.
__device__ __forceinline__ int8_t to_int8(float v) {
  if (isnan(v)) return 0;
  v = fminf(fmaxf(v, -128.f), 127.f);
  return static_cast<int8_t>(__float2int_rz(v));
}

// Pass 1: norm_bits[block] = max over the block of the bits of |x|.
template <typename T>
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const T* __restrict__ x, long long block_elems, int chunks,
              unsigned* __restrict__ norm_bits) {
  const long long blk = blockIdx.x / chunks;
  const long long lo = (blockIdx.x % chunks) * CHUNK;
  const T* xb = x + blk * block_elems;
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const long long e = lo + i * THREADS + threadIdx.x;
    if (e < block_elems) m = max(m, __float_as_uint(to_f32(xb[e])) & 0x7fffffffu);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned warp_max[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < THREADS / 32 ? warp_max[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(&norm_bits[blk], m);
  }
}

// Pass 2: the levels of one chunk, and (chunk 0) the block's scale.
template <typename T>
__global__ void __launch_bounds__(THREADS)
encode_kernel(const T* __restrict__ x, const float* __restrict__ u, float s,
              long long block_elems, int chunks,
              const unsigned* __restrict__ norm_bits,
              int8_t* __restrict__ levels, float* __restrict__ scale) {
  const long long blk = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const long long lo = chunk * CHUNK;
  float norm = __uint_as_float(norm_bits[blk]);
  if (norm == 0.f) norm = 1.f;
  const long long base = blk * block_elems;
#pragma unroll 4
  for (int i = 0; i < PER_THREAD; ++i) {
    const long long e = lo + i * THREADS + threadIdx.x;
    if (e >= block_elems) break;
    const float y = __fmul_rn(__fdiv_rn(to_f32(x[base + e]), norm), s);
    const float fl = floorf(y);
    const float up = u[base + e] < __fsub_rn(y, fl) ? 1.f : 0.f;
    levels[base + e] = to_int8(__fadd_rn(fl, up));
  }
  if (chunk == 0 && threadIdx.x == 0) scale[blk] = __fdiv_rn(norm, s);
}

// out = float(level) * scale[block]; 16 levels a thread (one 16-byte load,
// four 16-byte stores), the last n % 16 one a thread.
__global__ void __launch_bounds__(THREADS)
decode_kernel(const int8_t* __restrict__ levels,
              const float* __restrict__ scale, long long n,
              long long block_elems, float* __restrict__ out) {
  const long long nvec = n / 16;
  const long long first = blockIdx.x * (long long)THREADS + threadIdx.x;
  for (long long v = first; v < nvec; v += (long long)gridDim.x * THREADS) {
    const long long i0 = v * 16;
    const int4 raw = reinterpret_cast<const int4*>(levels)[v];
    const int8_t* lv = reinterpret_cast<const int8_t*>(&raw);
    long long blk = i0 / block_elems;
    long long next = (blk + 1) * block_elems;
    float sc = scale[blk];
    float r[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (i0 + j == next) {          // the vector crosses into a new block
        ++blk;
        next += block_elems;
        sc = scale[blk];
      }
      r[j] = __fmul_rn(static_cast<float>(lv[j]), sc);
    }
    float4* o = reinterpret_cast<float4*>(out + i0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      o[j] = make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
  }
  const long long t = nvec * 16 + first;
  if (first < 16 && t < n)
    out[t] = __fmul_rn(static_cast<float>(levels[t]), scale[t / block_elems]);
}

template <typename T>
cudaError_t encode(const void* x, const void* u, float s, long long rows,
                   long long cols, long long block_rows, unsigned* norm_bits,
                   void* levels, void* scale, cudaStream_t stream) {
  const long long nb = rows / block_rows;
  const long long block_elems = block_rows * cols;
  const long long chunks = (block_elems + CHUNK - 1) / CHUNK;
  if (nb < 1 || nb * chunks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(norm_bits, 0, nb * sizeof(unsigned), stream);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>(nb * chunks);
  absmax_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), block_elems, static_cast<int>(chunks),
      norm_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  encode_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(u), s, block_elems,
      static_cast<int>(chunks), norm_bits, static_cast<int8_t*>(levels),
      static_cast<float*>(scale));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, cols] (dtype 0 = float32, 1 = bfloat16), u [rows, cols] float32,
// both contiguous; rows % block_rows == 0.  Writes levels int8 [rows, cols]
// and scale float32 [rows / block_rows]; norm_bits is scratch of
// rows / block_rows uint32.  Returns cudaGetLastError() (0 on success).
int repro_dither_encode(const void* x, int dtype, const void* u, float s,
                        long long rows, long long cols, long long block_rows,
                        void* norm_bits, void* levels, void* scale,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* nbits = static_cast<unsigned*>(norm_bits);
  cudaError_t err =
      dtype == 0 ? encode<float>(x, u, s, rows, cols, block_rows, nbits,
                                 levels, scale, st)
      : dtype == 1 ? encode<__nv_bfloat16>(x, u, s, rows, cols, block_rows,
                                           nbits, levels, scale, st)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// levels int8 [rows, cols] (16-byte aligned), scale float32
// [rows / block_rows] -> out float32 [rows, cols] (16-byte aligned).
int repro_dither_decode(const void* levels, const void* scale, long long rows,
                        long long cols, long long block_rows, void* out,
                        void* stream) {
  const long long n = rows * cols;
  const long long block_elems = block_rows * cols;
  if (block_elems < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n / 16 + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 132 * 32) blocks = 132 * 32;     // grid-stride beyond this
  decode_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(levels), static_cast<const float*>(scale), n,
      block_elems, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
