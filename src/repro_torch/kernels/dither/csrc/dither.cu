// Random-dithering int8 codec for Hopper (sm_90a): encode and decode.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dither/dither.py:
// `_encode_kernel` (:25, called by `dither_encode`) and `_decode_kernel`
// (:62, called by `dither_decode`).
//   encode: for each block of `block_rows` rows of x [R, C], norm = max |x|
//           over the block (0 -> 1), y = x / norm * s, lo = floor(y),
//           level = lo + (u < y - lo) as int8, and scale = norm / s;
//   decode: out = float(level) * scale[block].
// The encode has two entries: one reads the uniforms u [R, C] from device
// memory (the counterpart of the Pallas wrapper), the keyed one draws them
// in registers, u[i] = uniform(key, (R, C))[i] from the flat index i
// (threefry.cuh; bit for bit repro_torch.random.uniform, which is
// jax.random's), so no uniform ever reaches device memory.
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
//      CTA of chunk 0 writes the block's scale.  The keyed pass reads x in
//      vectors of four (16 bytes of float32) and stores four levels at once
//      where the block's length and x's address allow it.
// A small block (the 8 x 512 default of `quantize`) is one chunk: one CTA
// per block in each pass.  The keyed encode's passes are also entries of
// their own (repro_dither_absmax, repro_dither_levels_keyed): n federated
// workers quantize their leaves against one norm, the maximum over all of
// them (the reference's `pmax`, compressors.py `shared_scale_levels`), so
// pass 1 runs over every worker's leaf into one norm, which an all-reduce
// may then widen across processes, before any worker's pass 2.  The norm
// stays in device memory between the passes.
//
// What bounds it on this card.  The u-taking encode: bytes; it must read x
// and u and write the levels, 9 B an element for float32 x (7 B for
// bfloat16); it reads x twice (13 B), because a block does not fit on
// chip.  The keyed encode must move 5 B an element (x once, the levels),
// and reads x twice (9 B); but its threefry and level take more issue
// than that.  Its main loop, read from the SASS of
// encode_keyed_kernel<float, true> (cuobjdump -sass; eight elements a
// trip, the division's slow path not taken), spends an element 58.25
// instructions on the integer and logic ALU (the 20 rounds' funnel shifts
// and xors, three-input adds, compares, byte packing), 23.25 on the FMA
// pipe's integer half (adds moved there as IMAD.IADD, which issue beside
// the ALU), 9 float32 adds and products, 3 on the conversion unit and
// 97.875 in all.  An sm_90 SM takes 64 a clock on the ALU and on the FMA
// pipe's integer half, 128 float32 operations, 16 conversions and 128
// issue slots: the ALU is the busiest, 0.910 clocks an element, 0.884 ms
// at the FFN leaf [45056, 5632] at 1.98 GHz on 132 SMs, against 0.38 ms
// for 5 B an element, so its bound is the ALU's instructions
// (chip_smoke.keyed_encode_clocks_per_element counts them from the
// library it runs).  Measured there: 1.328 ms, 67% of that bound, against
// 1.370 ms for the u-taking encode and 283 ms for the draw of u in int64
// tensor ops that it replaces (kernel_timing.py dither; NVIDIA H100 80GB
// HBM3, 700 W).  The decode must read 1 B and write 4 B an element: bytes
// bound it.  A thread loads 4 levels (4 bytes) and stores one float4, so a
// warp's load and store are each one contiguous run (128 B, 512 B), with
// four such vectors a thread in flight: 0.470 ms at the FFN leaf, 81% of
// its 0.379 ms bound, against 0.789 ms with 16 levels a thread (a warp's
// float4 store then spans 2 KB at a 64-byte stride) and 0.882 ms for
// torch.mul(levels.view(1, -1), scale[:, None]) (kernel_timing.py dither;
// NVIDIA H100 80GB HBM3, 700 W).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "../../csrc/threefry.cuh"

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

// One element's level from x, its uniform and the block's norm.
__device__ __forceinline__ int8_t level(float xv, float u, float norm,
                                        float s) {
  const float y = __fmul_rn(__fdiv_rn(xv, norm), s);
  const float fl = floorf(y);
  const float up = u < __fsub_rn(y, fl) ? 1.f : 0.f;
  return to_int8(__fadd_rn(fl, up));
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
    levels[base + e] = level(to_f32(x[base + e]), u[base + e], norm, s);
  }
  if (chunk == 0 && threadIdx.x == 0) scale[blk] = __fdiv_rn(norm, s);
}

// Four consecutive elements of x (n of them inside the block) as float32;
// VEC: one 16-byte (float32) or 8-byte (bfloat16) load.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* p, int n, float (&out)[4]) {
  if constexpr (!VEC) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = j < n ? to_f32(p[j]) : 0.f;
  } else if constexpr (sizeof(T) == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {                     // bfloat16 is the top half of a float32
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

// Pass 2 of the keyed encode: as encode_kernel, with u[i] drawn in
// registers from the key's two words (the int64 [2] tensor of
// repro_torch.random, read on the device) and the flat index i.  A thread
// takes four vectors of four consecutive elements, a warp's vectors
// adjacent.  VEC: the block's length is a multiple of 4 and x is aligned,
// so every vector is whole and aligned.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
encode_keyed_kernel(const T* __restrict__ x,
                    const long long* __restrict__ key, float s,
                    long long block_elems, int chunks,
                    const unsigned* __restrict__ norm_bits,
                    int8_t* __restrict__ levels, float* __restrict__ scale) {
  const long long blk = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const long long lo = chunk * CHUNK;
  float norm = __uint_as_float(norm_bits[blk]);
  if (norm == 0.f) norm = 1.f;
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const long long base = blk * block_elems;
#pragma unroll 2
  for (int i = 0; i < PER_THREAD / 4; ++i) {
    const long long e = lo + 4 * (i * THREADS + threadIdx.x);
    if (e >= block_elems) break;
    const long long left = block_elems - e;
    const int n = left < 4 ? static_cast<int>(left) : 4;
    float xv[4];
    load4<T, VEC>(x + base + e, n, xv);
    int8_t lv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      lv[j] = level(xv[j], repro_threefry::uniform_at(
                               k0, k1, static_cast<unsigned long long>(
                                           base + e + j)),
                    norm, s);
    if constexpr (VEC) {
      *reinterpret_cast<char4*>(levels + base + e) =
          make_char4(lv[0], lv[1], lv[2], lv[3]);
    } else {
      for (int j = 0; j < n; ++j) levels[base + e + j] = lv[j];
    }
  }
  if (chunk == 0 && threadIdx.x == 0) scale[blk] = __fdiv_rn(norm, s);
}

// Vectors of four levels a decode thread keeps in flight: their loads are
// all issued before the first store.
constexpr int DECODE_VECS = 4;

// out = float(level) * scale[block], four levels a vector: one 4-byte load
// (a warp reads 128 contiguous bytes) and one 16-byte store (a warp writes
// 512 contiguous bytes) a vector, DECODE_VECS vectors a thread in flight,
// strided by the grid's width.  Needs block_elems % 4 == 0 (a vector never
// crosses a block), levels 4-byte and out 16-byte aligned.  Indices are
// 64-bit (a tensor may hold more than 2^31 levels).  Each vector's block
// is carried from trip to trip as a quotient and remainder advanced by the
// trip's step, so the loop divides nothing: a 64-bit division a vector
// took 0.501 ms at [45056, 5632], against 0.470 carried and 0.473 for a
// 32-bit division (kernel_timing.py dither; NVIDIA H100 80GB HBM3, 700 W).
using Idx = unsigned long long;
__global__ void __launch_bounds__(THREADS)
decode_kernel(const int8_t* __restrict__ levels,
              const float* __restrict__ scale, Idx nvec, Idx block_vecs,
              float* __restrict__ out) {
  const char4* lv = reinterpret_cast<const char4*>(levels);
  float4* o = reinterpret_cast<float4*>(out);
  const Idx stride = static_cast<Idx>(gridDim.x) * THREADS;
  const Idx step = DECODE_VECS * stride;
  const Idx step_q = step / block_vecs, step_r = step % block_vecs;
  Idx v0 = static_cast<Idx>(blockIdx.x) * THREADS + threadIdx.x;
  Idx q[DECODE_VECS], r[DECODE_VECS];
#pragma unroll
  for (int j = 0; j < DECODE_VECS; ++j) {
    q[j] = (v0 + j * stride) / block_vecs;
    r[j] = (v0 + j * stride) - q[j] * block_vecs;
  }
  for (; v0 < nvec; v0 += step) {
    char4 raw[DECODE_VECS];
#pragma unroll
    for (int j = 0; j < DECODE_VECS; ++j) {
      const Idx v = v0 + j * stride;
      if (v < nvec) raw[j] = lv[v];
    }
#pragma unroll
    for (int j = 0; j < DECODE_VECS; ++j) {
      const Idx v = v0 + j * stride;
      if (v < nvec) {
        const float sc = __ldg(scale + q[j]);
        o[v] = make_float4(__fmul_rn(static_cast<float>(raw[j].x), sc),
                           __fmul_rn(static_cast<float>(raw[j].y), sc),
                           __fmul_rn(static_cast<float>(raw[j].z), sc),
                           __fmul_rn(static_cast<float>(raw[j].w), sc));
      }
      q[j] += step_q;
      r[j] += step_r;
      if (r[j] >= block_vecs) {
        r[j] -= block_vecs;
        ++q[j];
      }
    }
  }
}

// The scalar decode: one level a thread at a time, for blocks whose length
// is not a multiple of 4 and unaligned operands.
__global__ void __launch_bounds__(THREADS)
decode_scalar_kernel(const int8_t* __restrict__ levels,
                     const float* __restrict__ scale, long long n,
                     long long block_elems, float* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long i = blockIdx.x * static_cast<long long>(THREADS)
                     + threadIdx.x;
       i < n; i += stride)
    out[i] = __fmul_rn(static_cast<float>(levels[i]),
                       __ldg(scale + i / block_elems));
}

// The launch shape of both passes over x [rows, cols] in blocks of
// block_rows rows: a CTA a (block, chunk of CHUNK elements).
struct Grid {
  long long nb, block_elems, chunks;
  bool ok() const { return nb >= 1 && nb * chunks <= 0x7fffffffLL; }
  unsigned ctas() const { return static_cast<unsigned>(nb * chunks); }
};

Grid grid_of(long long rows, long long cols, long long block_rows) {
  Grid g{block_rows < 1 ? 0 : rows / block_rows, block_rows * cols, 0};
  g.chunks = (g.block_elems + CHUNK - 1) / CHUNK;
  return g;
}

// Pass 1: max |x| of each block into norm_bits, which the caller zeroes
// (or holds the maxima of other workers' leaves, merged by atomicMax).
template <typename T>
cudaError_t absmax_pass(const void* x, const Grid& g, unsigned* norm_bits,
                        cudaStream_t stream) {
  absmax_kernel<T><<<g.ctas(), THREADS, 0, stream>>>(
      static_cast<const T*>(x), g.block_elems, static_cast<int>(g.chunks),
      norm_bits);
  return cudaGetLastError();
}

// Pass 2 of the keyed encode from the norms in norm_bits.
template <typename T>
cudaError_t keyed_levels_pass(const void* x, const void* key, float s,
                              const Grid& g, const unsigned* norm_bits,
                              void* levels, void* scale,
                              cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const long long* k = static_cast<const long long*>(key);
  int8_t* lv = static_cast<int8_t*>(levels);
  float* sc = static_cast<float*>(scale);
  const int c = static_cast<int>(g.chunks);
  const bool vec = g.block_elems % 4 == 0
                   && reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0
                   && reinterpret_cast<uintptr_t>(levels) % 4 == 0;
  if (vec)
    encode_keyed_kernel<T, true><<<g.ctas(), THREADS, 0, stream>>>(
        xt, k, s, g.block_elems, c, norm_bits, lv, sc);
  else
    encode_keyed_kernel<T, false><<<g.ctas(), THREADS, 0, stream>>>(
        xt, k, s, g.block_elems, c, norm_bits, lv, sc);
  return cudaGetLastError();
}

// Both fused encodes: zeroed norms, pass 1, then pass 2 from u (key null)
// or drawn from key.
template <typename T>
cudaError_t encode(const void* x, const void* u, const void* key, float s,
                   long long rows, long long cols, long long block_rows,
                   unsigned* norm_bits, void* levels, void* scale,
                   cudaStream_t stream) {
  const Grid g = grid_of(rows, cols, block_rows);
  if (!g.ok()) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaMemsetAsync(norm_bits, 0, g.nb * sizeof(unsigned), stream);
  if (err == cudaSuccess) err = absmax_pass<T>(x, g, norm_bits, stream);
  if (err != cudaSuccess) return err;
  if (key != nullptr)
    return keyed_levels_pass<T>(x, key, s, g, norm_bits, levels, scale,
                                stream);
  encode_kernel<T><<<g.ctas(), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(u), s,
      g.block_elems, static_cast<int>(g.chunks), norm_bits,
      static_cast<int8_t*>(levels), static_cast<float*>(scale));
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
      dtype == 0 ? encode<float>(x, u, nullptr, s, rows, cols, block_rows,
                                 nbits, levels, scale, st)
      : dtype == 1 ? encode<__nv_bfloat16>(x, u, nullptr, s, rows, cols,
                                           block_rows, nbits, levels, scale,
                                           st)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// As repro_dither_encode, with u = uniform(key, (rows, cols)) drawn in
// registers: key is the int64 [2] device tensor of repro_torch.random (two
// uint32 words), read by the kernel.
int repro_dither_encode_keyed(const void* x, int dtype, const void* key,
                              float s, long long rows, long long cols,
                              long long block_rows, void* norm_bits,
                              void* levels, void* scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* nbits = static_cast<unsigned*>(norm_bits);
  if (key == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      dtype == 0 ? encode<float>(x, nullptr, key, s, rows, cols, block_rows,
                                 nbits, levels, scale, st)
      : dtype == 1 ? encode<__nv_bfloat16>(x, nullptr, key, s, rows, cols,
                                           block_rows, nbits, levels, scale,
                                           st)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The keyed encode's two passes as entries of their own, for norms shared
// by several workers: repro_dither_absmax merges max |x| of each block of x
// into norm_bits (uint32 bits of non-negative floats, zeroed by the caller
// before the first worker's leaf; not zeroed here), so successive workers'
// leaves give the maximum over the workers without being stacked, and an
// all-reduce of norm_bits (MAX) gives it across processes;
// repro_dither_levels_keyed then writes the levels and scales from those
// norms.  The two in a row are repro_dither_encode_keyed.
int repro_dither_absmax(const void* x, int dtype, long long rows,
                        long long cols, long long block_rows,
                        void* norm_bits, void* stream) {
  const Grid g = grid_of(rows, cols, block_rows);
  if (!g.ok()) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* nbits = static_cast<unsigned*>(norm_bits);
  cudaError_t err = dtype == 0 ? absmax_pass<float>(x, g, nbits, st)
                    : dtype == 1 ? absmax_pass<__nv_bfloat16>(x, g, nbits, st)
                                 : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

int repro_dither_levels_keyed(const void* x, int dtype, const void* key,
                              float s, long long rows, long long cols,
                              long long block_rows, const void* norm_bits,
                              void* levels, void* scale, void* stream) {
  const Grid g = grid_of(rows, cols, block_rows);
  if (!g.ok() || key == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned* nbits = static_cast<const unsigned*>(norm_bits);
  cudaError_t err =
      dtype == 0 ? keyed_levels_pass<float>(x, key, s, g, nbits, levels,
                                            scale, st)
      : dtype == 1 ? keyed_levels_pass<__nv_bfloat16>(x, key, s, g, nbits,
                                                      levels, scale, st)
                   : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// levels int8 [rows, cols], scale float32 [rows / block_rows] -> out
// float32 [rows, cols], any alignment: the vector kernel where the block
// length is a multiple of 4, levels are 4-byte and out 16-byte aligned,
// else the scalar kernel.
int repro_dither_decode(const void* levels, const void* scale, long long rows,
                        long long cols, long long block_rows, void* out,
                        void* stream) {
  const long long n = rows * cols;
  const long long block_elems = block_rows * cols;
  if (block_elems < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // eight CTAs of 256 threads an SM fill it; the grid strides beyond that
  const long long most = 8LL * sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* lv = static_cast<const int8_t*>(levels);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  const bool vec = block_elems % 4 == 0
                   && reinterpret_cast<uintptr_t>(levels) % 4 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto grid_for = [most](long long items, long long per_cta) {
    const long long g = (items + per_cta - 1) / per_cta;
    return static_cast<unsigned>(g < most ? g : most);
  };
  if (vec) {
    // a block of a multiple of 4 elements makes n one too: no tail
    const long long nvec = n / 4;
    const unsigned grid = grid_for(nvec, THREADS * DECODE_VECS);
    decode_kernel<<<grid, THREADS, 0, st>>>(lv, sc, nvec, block_elems / 4,
                                            o);
  } else {
    decode_scalar_kernel<<<grid_for(n, THREADS), THREADS, 0, st>>>(
        lv, sc, n, block_elems, o);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
