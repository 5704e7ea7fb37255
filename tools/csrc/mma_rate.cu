// The issue rate of mma.sync m16n8k8 TF32 on this card, alone and beside
// the split instructions of the 3xTF32 kernels: not a kernel of any path,
// a measurement for kernel_timing.py mma-rate (PERF.md: what bounds the
// float32 flash kernels).  Each warp issues eight independent accumulator
// chains; with `mixed`, each mma.sync comes with three integer and float
// operations, the cost of splitting one operand element (to_tf32 and the
// remainder), as the float32 flash forward spends about three an mma.sync.
// Each CTA reports the SM cycles (clock64) of its loop.
#include <cuda_runtime.h>

#include "tensor_core.cuh"

using namespace repro_tc;

namespace {

template <bool MIXED>
__global__ void mma_rate_kernel(int iters, long long* cycles, float* sink) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = to_tf32(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = to_tf32(1e-3f * (threadIdx.x - i));
  float c[8][4];
  zero(c);
  float x[8];
  for (int i = 0; i < 8; ++i) x[i] = 1e-3f * (threadIdx.x * 8 + i);
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(c[j], a, b);
    if (MIXED) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {     // a split: to_tf32, the remainder
        const unsigned h = to_tf32(x[j]);
        x[j] = x[j] - __uint_as_float(h) + 1e-7f;
      }
      b[0] ^= __float_as_uint(x[0]) & 1u;
    }
  }
  const long long t1 = clock64();
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    s += c[j][0] + c[j][1] + c[j][2] + c[j][3] + x[j];
  if (s == 12345.f) sink[0] = s;       // keeps the products
}

}  // namespace

extern "C" {

// blocks CTAs of `threads` threads, `iters` iterations of eight mma.sync
// a warp; cycles: int64 [blocks]; sink: float32 [1].  Returns the launch's
// cudaGetLastError().
int repro_mma_rate(int blocks, int threads, int iters, int mixed,
                   void* cycles, void* sink, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* cyc = static_cast<long long*>(cycles);
  float* out = static_cast<float*>(sink);
  if (mixed)
    mma_rate_kernel<true><<<blocks, threads, 0, s>>>(iters, cyc, out);
  else
    mma_rate_kernel<false><<<blocks, threads, 0, s>>>(iters, cyc, out);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
