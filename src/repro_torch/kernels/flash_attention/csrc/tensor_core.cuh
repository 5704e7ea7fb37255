// The float32 tensor-core machinery of the flash-attention kernels, shared
// by flash_attention.cu (forward and backward) and flash_attention_jvp.cu
// (their tangents): 16-byte cp.async staging of [rows, D] tiles into
// shared memory with rows padded by 16 bytes, float32 products as 3xTF32
// on mma.sync m16n8k8 (Tc<float>: fragment loads that split each operand
// into a TF32 high part and its remainder, and three products a step),
// and add_to, which sums each tile's products into a running float32 sum.
// flash_attention.cu adds Tc<__nv_bfloat16>.
#pragma once

#include <cuda_runtime.h>

namespace repro_tc {

constexpr int TC_THREADS = 128;  // four warps, 16 rows of a tile each

// padded row length of a staged [rows, D] tile: 16 more bytes
template <typename T, int D>
__host__ __device__ constexpr int row_ld() { return D + 16 / (int)sizeof(T); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where !in.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// R rows of a [.., S, D] operand (row `lo` on) into a padded [R][ld] tile,
// zeros past S.  Every row start is 16-byte aligned (the wrapper copies
// an operand whose rows are not).
template <typename T, int D, int R>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long stride, int lo, int S) {
  constexpr int E = 16 / (int)sizeof(T), CPR = D / E, LD = row_ld<T, D>();
  for (int c = threadIdx.x; c < R * CPR; c += TC_THREADS) {
    const int r = c / CPR, col = (c % CPR) * E, row = lo + r;
    const bool in = row < S;
    cp_async16(dst + r * LD + col, in ? src + row * stride + col : src, in);
  }
}

// R floats of a row vector (element `lo` on), zeros past S.
template <int R>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int lo, int S) {
  for (int r = threadIdx.x; r < R; r += TC_THREADS) {
    const bool in = lo + r < S;
    cp_async4(dst + r, in ? src + lo + r : src, in);
  }
}

// cvt.rna.tf32.f32 (round to a 10-bit mantissa, ties away from zero) as
// two integer operations: the same bits for every finite x (cvt.rna also
// keeps a NaN a NaN; here a NaN turns into inf, and its product is NaN all
// the same).  The instruction itself compiles to four (a finite check, a
// select, an add, a mask), and the splits bound the float32 kernel.
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of one tensor-core step for element type T.  Lane = 4 g + t.
// An accumulator tile (16 x 8, float) holds c[0], c[1] at row g, columns
// 2t, 2t + 1 and c[2], c[3] at row g + 8.  Shared tiles are row-major with
// row length ld.  load_a: A[16 x KS] = s[m.., k..]; load_b_nk: B[KS x 8]
// with B[kk][nn] = s[n + nn][k + kk]; load_b_kn: B[kk][nn] = s[k + kk][n +
// nn] (k permuted as a_from_acc permutes it); a_from_acc: A from
// accumulator tiles (their columns are A's k).
template <typename T>
struct Tc;

// float32 as 3xTF32 on m16n8k8.
template <>
struct Tc<float> {
  static constexpr int KS = 8;
  struct A { unsigned hi[4], lo[4]; };
  struct B { unsigned hi[2], lo[2]; };

  static __device__ __forceinline__ void split(float x, unsigned& hi,
                                               unsigned& lo) {
    hi = to_tf32(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
  static __device__ __forceinline__ A a_of(float a0, float a1, float a2,
                                           float a3) {
    A f;
    split(a0, f.hi[0], f.lo[0]);
    split(a1, f.hi[1], f.lo[1]);
    split(a2, f.hi[2], f.lo[2]);
    split(a3, f.hi[3], f.lo[3]);
    return f;
  }
  // b0 (k = t, n = g), b1 (k = t + 4, n = g)
  static __device__ __forceinline__ B b_of(float b0, float b1) {
    B f;
    split(b0, f.hi[0], f.lo[0]);
    split(b1, f.hi[1], f.lo[1]);
    return f;
  }
  static __device__ __forceinline__ A load_a(const float* s, int ld, int m,
                                             int k, int g, int t) {
    const float* p = s + (m + g) * ld + k + t;
    return a_of(p[0], p[8 * ld], p[4], p[8 * ld + 4]);
  }
  static __device__ __forceinline__ B load_b_nk(const float* s, int ld,
                                                int n, int k, int g, int t) {
    const float* p = s + (n + g) * ld + k + t;
    return b_of(p[0], p[4]);
  }
  // k slot t is row k + 2t, slot t + 4 is row k + 2t + 1
  static __device__ __forceinline__ B load_b_kn(const float* s, int ld,
                                                int k, int n, int g, int t) {
    const float* p = s + (k + 2 * t) * ld + n + g;
    return b_of(p[0], p[ld]);
  }
  // k step i is accumulator tile i: slot t is its column 2t, slot t + 4
  // its column 2t + 1 (the permutation load_b_kn reads)
  template <int N>
  static __device__ __forceinline__ A a_from_acc(const float (&c)[N][4],
                                                 int i) {
    return a_of(c[i][0], c[i][2], c[i][1], c[i][3]);
  }
  // the small terms first
  static __device__ __forceinline__ void mma(float c[4], const A& a,
                                             const B& b) {
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.hi);
  }
};

// acc[j] += A B_j (j < NT): A = the 16 rows m.. of As (KD columns), B_j =
// the transpose of rows 8j.. of Bs (their KD columns).
template <typename T, int KD, int NT>
__device__ __forceinline__ void gemm_nt(float (&acc)[NT][4], const T* As,
                                        const T* Bs, int ld, int m, int g,
                                        int t) {
  using O = Tc<T>;
#pragma unroll
  for (int k = 0; k < KD; k += O::KS) {
    const typename O::A a = O::load_a(As, ld, m, k, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      O::mma(acc[j], a, O::load_b_nk(Bs, ld, 8 * j, k, g, t));
  }
}

// acc[j] += A B_j (j < NT): A = the accumulator tiles a (16 rows, NA * 8
// columns), B_j = columns 8j.. of the NA * 8 rows of Bs.
template <typename T, int NT, int NA>
__device__ __forceinline__ void gemm_rn(float (&acc)[NT][4],
                                        const float (&a)[NA][4], const T* Bs,
                                        int ld, int g, int t) {
  using O = Tc<T>;
#pragma unroll
  for (int k = 0; k < NA * 8; k += O::KS) {
    const typename O::A af = O::a_from_acc(a, k / O::KS);
#pragma unroll
    for (int j = 0; j < NT; ++j)
      O::mma(acc[j], af, O::load_b_kn(Bs, ld, k, 8 * j, g, t));
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
}

// acc += part, rounded to nearest.  mma.sync does not add its products
// into a float32 accumulator as a float32 add would: a chain of thousands
// of them on one accumulator (the 8,192 terms of a dK or dV entry at B=8,
// H=32, KV=4, S=1024, D=64) drifted beyond the float32 tolerance (1e-5 of
// max |grad|) on an H100; with each step's tile (a few dozen mma.sync)
// summed apart and added here, it stays well inside it.
template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&part)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int window) {
  bool keep = qpos >= kpos && qpos < S;
  if (window) keep = keep && (qpos - kpos) < window;
  return keep;
}

}  // namespace repro_tc
