// Causal GQA flash attention for Hopper (sm_90a): the forward kernel and,
// below it, the backward kernels, all on the tensor cores: float32 as
// 3xTF32 on mma.sync, the bf16 forward on mma.sync, the bf16 backward on
// wgmma (its own section, namespace wg).
//
// Replaces the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention/flash_attention.py:28 (`flash_attention`):
// online-softmax attention with an optional sliding window and tanh
// soft-cap, skipping KV tiles that no query of the tile can see.
//
// What it must reproduce (the reference's own choices):
//   * scores are scaled after the dot product, then soft-capped
//     (cap * tanh(s / cap)), then masked;
//   * the mask value is the finite NEG = -1e30, not -inf: a row that is
//     fully masked within a live tile gets p = exp(NEG - NEG) = 1, which
//     corr = exp(NEG - m_real) = 0 wipes once a real score arrives (with
//     -inf it would be NaN); l == 0 becomes 1 at the end;
//   * GQA: query head h reads KV head h / (H / KV);
//   * query i sits at key position i (Sq == Sk; the wrapper checks it).
//
// Forward design.  One CTA of four warps per (64-row q tile, head, batch),
// each warp 16 query rows, looping over the live KV tiles from the first
// one the window lets in to the diagonal one (the Pallas grid's sequential
// fourth axis); one linear grid with the q tile slowest, so the q tiles
// with the most KV tiles start first.  Per KV tile, in registers:
//   S = Q K^T on mma.sync (K as it lies is the `col` B operand), scaled,
//   capped and masked (a warp whose 16 rows see the whole tile skips the
//   mask: every tile but the diagonal one and the window's edge); the
//   online softmax across the four lanes that share an accumulator row
//   (quad shuffles); then O = O * corr + P V, with P the A operand
//   straight from the S accumulators (a_from_acc) and V read across rows
//   (load_b_kn; ldmatrix.trans in bf16).  Each tile's P V is summed in an
//   accumulator of its own and added to the rescaled O in float32
//   (add_to): long mma.sync chains are not float32 sums (see add_to).  K
//   and V tiles are double-buffered with cp.async; shared rows are padded
//   by 16 bytes, so both fragment patterns are conflict-free.  The last q
//   tile may be ragged: rows and keys past S are zero-filled and never
//   stored.  No float atomics: two runs give the same bits.
//   * float32: 3xTF32 (a.b ~ a_hi.b_lo + a_lo.b_hi + a_hi.b_hi, as the
//     backward below); Q is split once, into registers, at the CTA's start
//     (at D = 128 its fragments would take 128 registers: there it is split
//     at each load).  K and V are split at each fragment load: each of the
//     four warps splits every K and V element again, but splitting each
//     staged tile once (hi in place, lo in a tile of its own: a second
//     shared load an operand and 40% more shared memory) was slower at the
//     serving shape below, f32: 64-key tiles 0.789 ms split at load, 1.349
//     ms split staged (122 KB, one CTA an SM); 32-key tiles 0.817 and 0.933
//     ms (kernel_timing.py flash-forward, -D REPRO_FWD_BK=32; NVIDIA H100
//     80GB HBM3, 700 W).  The staged split was a variant of this kernel
//     behind -D REPRO_FWD_SPLIT_STAGED=1, removed once it lost: it is not
//     in this source, so its two times cannot be taken again from the
//     tree (PERF.md keeps them).  So 64-key tiles, split at load: 87 KB,
//     two CTAs an SM.
//   * bfloat16: m16n8k16, P rounded to bf16 as the A operand (as FA2 does);
//     the row sums l are taken from the float32 P.
//   * Head dims: the kernel is a template on Q's and K's head dim DK and
//     V's and O's DV (the scale stays 1/sqrt(DK)), built for (32, 32),
//     (64, 64), (128, 128), (256, 256) (gemma2, recurrentgemma) and MLA's
//     (192, 128) (deepseek-v3: qk_nope 128 + qk_rope 64 against
//     v_head_dim 128, V never padded to 192).  From max(DK, DV) = 128 on,
//     32-key tiles; at DV = 256 the P V pass sums 64 output columns apart
//     at a time (fwd_pv_tiles), so O's 128 float32 accumulators a thread
//     leave room for the pass's own; at DK = 256 in float32 Q, K and V
//     take 195 KB of shared memory, one CTA an SM.
// The optional float32 log-sum-exp output m + log(l) ([B, H, S]) feeds the
// backward; given a null pointer the forward writes nothing else.
//
// What bounds the forward on this card: operations.  At the serving shape
// (B=8, H=32, KV=4, S=1024, D=64) the causal work is 4*B*H*S^2*D/2 =
// 3.4e10 operations against 0.15 GB of inputs and output (0.045 ms): as
// 3xTF32, three times the operations at 495 TFLOP/s, 0.208 ms; in bf16
// 0.035 ms at 989 TFLOP/s.  In float32 the split instructions (three
// integer and float operations an operand element beside its share of
// three mma.sync) compete with the mma.sync for issue slots, and at 240
// registers a thread two CTAs (eight warps) an SM hide little latency:
// 0.781 ms, 3.75x the bound (SDPA in float32: 5.21 ms).  bf16: 0.290 ms
// with V's B fragments loaded by ldmatrix.trans, 0.335 ms with 16-bit
// loads, against SDPA's bf16 0.106 ms (kernel_timing.py flash-forward, the
// two versions in turns in one call; NVIDIA H100 80GB HBM3, 700 W).  wgmma
// and TMA are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tensor_core.cuh"

namespace repro_tc {

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bfloat16 on m16n8k16; a register holds two values, the lower column (or
// k) in its low half.
template <>
struct Tc<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static constexpr int KS = 16;
  struct A { unsigned r[4]; };
  struct B { unsigned r[2]; };

  static __device__ __forceinline__ unsigned pair(const T* p) {
    return *reinterpret_cast<const unsigned*>(p);
  }
  static __device__ __forceinline__ unsigned pack(T lo, T hi) {
    return (unsigned)__bfloat16_as_ushort(lo)
           | ((unsigned)__bfloat16_as_ushort(hi) << 16);
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
  }
  // a0 (g, 2t..2t+1), a1 (g + 8, ..), a2 (g, 2t+8..2t+9), a3 (g + 8, ..)
  static __device__ __forceinline__ A load_a(const T* s, int ld, int m,
                                             int k, int g, int t) {
    const T* p = s + (m + g) * ld + k + 2 * t;
    return {{pair(p), pair(p + 8 * ld), pair(p + 8), pair(p + 8 * ld + 8)}};
  }
  // b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
  static __device__ __forceinline__ B load_b_nk(const T* s, int ld, int n,
                                                int k, int g, int t) {
    const T* p = s + (n + g) * ld + k + 2 * t;
    return {{pair(p), pair(p + 8)}};
  }
  static __device__ __forceinline__ B load_b_kn(const T* s, int ld, int k,
                                                int n, int g, int t) {
    const T* p = s + (k + 2 * t) * ld + n + g;
    return {{pack(p[0], p[ld]), pack(p[8 * ld], p[9 * ld])}};
  }
  // load_b_kn of columns n.. (b0) and n + 8.. (b1) with one ldmatrix
  // .x4.trans: lane L gives the address of row k + L % 8 (+ 8 for the odd
  // matrices), column n (+ 8 for matrices 2 and 3); every row starts on
  // 16 bytes
  static __device__ __forceinline__ void load_b_kn2(const T* s, int ld,
                                                    int k, int n, int lane,
                                                    B& b0, B& b1) {
    const T* p = s + (k + lane % 8 + (lane & 8)) * ld + n + (lane & 16) / 2;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0,%1,%2,%3}, [%4];\n"
        : "=r"(b0.r[0]), "=r"(b0.r[1]), "=r"(b1.r[0]), "=r"(b1.r[1])
        : "r"(smem_addr(p)));
  }
  // k step i is accumulator tiles 2i and 2i + 1
  template <int N>
  static __device__ __forceinline__ A a_from_acc(const float (&c)[N][4],
                                                 int i) {
    const float(&x)[4] = c[2 * i];
    const float(&y)[4] = c[2 * i + 1];
    return {{pack(x[0], x[1]), pack(x[2], x[3]), pack(y[0], y[1]),
             pack(y[2], y[3])}};
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a,
                                             const B& b) {
    mma_bf16(c, a.r, b.r);
  }
};

}  // namespace repro_tc

using namespace repro_tc;

namespace {

constexpr int THREADS = 256;     // the Delta kernel: eight rows a block
constexpr float NEG = -1e30f;

struct Strides {               // in elements; the head dimension has stride 1
  long long q[3], k[3], v[3], o[3];   // batch, head, sequence
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// Forward (design in the header above).
// ---------------------------------------------------------------------------

// The KV tile at D <= 64 may be set with -D to time other choices
// (kernel_timing.py flash-forward).
#ifndef REPRO_FWD_BK
#define REPRO_FWD_BK 64
#endif

constexpr int FWD_BQ = 64;     // query rows per CTA

// keys a KV tile: Q's and K's head dim DK, V's and O's DV
template <int DK, int DV>
__host__ __device__ constexpr int fwd_bk() {
  return (DK > DV ? DK : DV) <= 64 ? REPRO_FWD_BK : 32;
}

// Q's A fragments held in registers across the KV loop
template <typename T, int DK>
__host__ __device__ constexpr bool fwd_q_regs() {
  return sizeof(T) == 2 ? DK <= 128 : DK <= 64;
}

// n-tiles of O a P V pass sums apart before adding them to O: all of them
// up to DV = 128; at DV = 256 eight (64 columns) at a time, so the pass's
// own accumulators take 32 registers a thread beside O's 128.  Each output
// column sees the same products in the same order either way.
template <int DV>
__host__ __device__ constexpr int fwd_pv_tiles() {
  return DV <= 128 ? DV / 8 : 8;
}

template <typename T, int DK, int DV>
constexpr size_t fwd_smem_bytes() {
  // Q; K and V twice
  constexpr int BK = fwd_bk<DK, DV>();
  return ((size_t)(FWD_BQ + 2 * BK) * row_ld<T, DK>()
          + (size_t)2 * BK * row_ld<T, DV>()) * sizeof(T);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int KV, int S, int window,
                 float cap, float scale, Strides st) {
  using O = Tc<T>;
  constexpr int BQ = FWD_BQ, BK = fwd_bk<DK, DV>();
  constexpr int LDK = row_ld<T, DK>(), LDV = row_ld<T, DV>();
  constexpr int NK = BK / 8, ND = DV / 8, NS = DK / O::KS;
  constexpr int NC = fwd_pv_tiles<DV>();
  constexpr bool QREG = fwd_q_regs<T, DK>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BQ][LDK]
  T* Ks = Qs + BQ * LDK;                    // [2][BK][LDK]
  T* Vs = Ks + 2 * BK * LDK;                // [2][BK][LDV]

  const int nq = (S + BQ - 1) / BQ;
  const int nb = gridDim.x / (nq * H);                       // batch size
  const int q_lo = (nq - 1 - (int)(blockIdx.x / (H * nb))) * BQ;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % nb;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;

  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];
  // live KV tiles: from the one holding the first key that row q_lo may
  // see (q_lo - window + 1) to the one holding the last row's own key
  const int q_hi = min(q_lo + BQ - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;
  auto stage = [&](int jt) {
    const int buf = (jt - j_lo) & 1;
    stage_rows<T, DK, BK>(Ks + buf * BK * LDK, kb, st.k[2], jt * BK, S);
    stage_rows<T, DV, BK>(Vs + buf * BK * LDV, vb, st.v[2], jt * BK, S);
  };
  stage_rows<T, DK, BQ>(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q_lo,
                        S);
  stage(j_lo);
  cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16: running max and sum
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  float acc[ND][4];
  zero(acc);
  typename O::A qf[QREG ? NS : 1];

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    if (jt < j_hi) stage(jt + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles (and Q) have landed
    __syncthreads();
    const int buf = (jt - j_lo) & 1, k_lo = jt * BK;
    const T* Kb = Ks + buf * BK * LDK;
    const T* Vb = Vs + buf * BK * LDV;
    if constexpr (QREG) {
      if (jt == j_lo) {
#pragma unroll
        for (int i = 0; i < NS; ++i)
          qf[i] = O::load_a(Qs, LDK, m, i * O::KS, g, t);
      }
    }

    float s[NK][4];                                  // S = Q K^T
    zero(s);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      typename O::A a;
      if constexpr (QREG) a = qf[i];
      else a = O::load_a(Qs, LDK, m, i * O::KS, g, t);
#pragma unroll
      for (int j = 0; j < NK; ++j)
        O::mma(s[j], a, O::load_b_nk(Kb, LDK, 8 * j, i * O::KS, g, t));
    }

    // scale, cap, mask (only where the warp's 16 rows do not see the whole
    // tile); the tile's row max over the quad
    const bool seen = k_lo + BK - 1 <= q_lo + m
                      && (!window || q_lo + m + 15 - k_lo < window);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        if (!seen) {
          const int qpos = q_lo + m + g + 8 * r;
          const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
          bool keep = qpos >= kpos;
          if (window) keep = keep && (qpos - kpos) < window;
          x = keep ? x : NEG;
        }
        s[j][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_r[r], mx[r]);
      corr[r] = expf(m_r[r] - m_new);
      m_r[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_r[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * corr[r] + sum[r];
    }

    // O = O * corr + P V, the tile's P V summed apart, NC n-tiles a pass
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= corr[e >> 1];
#pragma unroll
    for (int jc = 0; jc < ND; jc += NC) {
      float part[NC][4];
      zero(part);
#pragma unroll
      for (int i = 0; i < BK; i += O::KS) {
        const typename O::A a = O::a_from_acc(s, i / O::KS);
        if constexpr (sizeof(T) == 2) {       // two n-tiles an ldmatrix
#pragma unroll
          for (int j = 0; j < NC; j += 2) {
            typename O::B b0, b1;
            O::load_b_kn2(Vb, LDV, i, 8 * (jc + j), lane, b0, b1);
            O::mma(part[j], a, b0);
            O::mma(part[j + 1], a, b1);
          }
        } else {
#pragma unroll
          for (int j = 0; j < NC; ++j)
            O::mma(part[j], a, O::load_b_kn(Vb, LDV, i, 8 * (jc + j), g,
                                            t));
        }
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jc + j][e] += part[j][e];
    }
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  T* ob = o + b * st.o[0] + h * st.o[1];
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l_r[r] == 0.f ? 1.f : l_r[r];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q_lo + m + g + (e & 2 ? 8 : 0);
      if (row < S)
        store(&ob[row * st.o[2] + 8 * j + 2 * t + (e & 1)],
              acc[j][e] / l[e >> 1]);
    }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q_lo + m + g + 8 * r;
      if (row < S)
        lse[((long long)b * H + h) * S + row] = m_r[r] + logf(l[r]);
    }
  }
}

template <typename T, int DK, int DV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KV, int S, int window,
                   float cap, const Strides& st, cudaStream_t stream) {
  const size_t bytes = fwd_smem_bytes<T, DK, DV>();
  auto kernel = flash_fwd_kernel<T, DK, DV>;
  // above 48 KB of shared memory a launch is refused unless allowed more
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)DK));
  const unsigned ctas = (S + FWD_BQ - 1) / FWD_BQ * H * B;
  kernel<<<ctas, TC_THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KV, S, window,
      cap, scale, st);
  return cudaGetLastError();
}

// The (DK, DV) pairs built: the square ones of the model's heads, and
// MLA's (qk_nope + qk_rope, v_head_dim) = (192, 128).  ops.FWD_HEAD_DIMS
// lists the same pairs.
template <typename T>
cudaError_t dispatch(int DK, int DV, const void* q, const void* k,
                     const void* v, void* o, float* lse, int B, int H,
                     int KV, int S, int window, float cap, const Strides& st,
                     cudaStream_t stream) {
#define REPRO_FWD_CASE(dk, dv)                                             \
  if (DK == dk && DV == dv)                                                \
    return launch<T, dk, dv>(q, k, v, o, lse, B, H, KV, S, window, cap, st, \
                             stream);
  REPRO_FWD_CASE(32, 32)
  REPRO_FWD_CASE(64, 64)
  REPRO_FWD_CASE(128, 128)
  REPRO_FWD_CASE(256, 256)
  REPRO_FWD_CASE(192, 128)
#undef REPRO_FWD_CASE
  return cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// Backward.  Replaces what the reference leaves to XLA: jax.grad of the
// model's chunked_attention (src/repro/models/attention.py:38); the Pallas
// kernel has no backward.  FA2-style: the probabilities are recomputed from
// the forward's log-sum-exp, P = exp(x - lse) with masked entries exactly 0:
//   Delta_i = rowsum(dO o O),  dV = P^T dO,  dP = dO V^T,
//   dS = P o (dP - Delta),  with a soft-cap dS *= 1 - tanh^2(s_raw / cap),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
//
// The products run on the tensor cores with mma.sync, accumulating in
// float32:
//   * float32 inputs as 3xTF32: each operand is split a = a_hi + a_lo with
//     a_hi = rna_tf32(a), a_lo = a - a_hi (passed as it is: the tensor
//     core reads its top 19 bits), and a.b ~ a_hi.b_lo + a_lo.b_hi +
//     a_hi.b_hi on m16n8k8 TF32 (the register-resident P and dS are split
//     the same way); rna_tf32 is cvt.rna.tf32.f32's rounding written as two
//     integer operations.  Rounding a_lo as well adds two integer
//     operations an element and gains no accuracy: 3.41-3.43 ms against
//     3.06-3.07 ms at the training shape below, 3.4e-6 of max |grad| either
//     way (kernel_timing.py flash-backward; H100 80GB HBM3, 700 W).  One
//     TF32 product keeps a 10-bit mantissa, 50x outside the float32
//     tolerance the port holds the gradients to (1e-5 of max |grad|); the
//     three keep about float32's accuracy.  TF32 stays off for every
//     other product of the port (device.py); nothing here reads that
//     switch.
//   * bfloat16 inputs: the kernels of the wgmma section below (same grids,
//     steps and arithmetic; P and dS rounded to bf16 as A operands, as FA2
//     does).
// Each step's products are summed in an accumulator of their own and added
// to the running dK, dV or dQ in float32 (add_to): a chain of thousands of
// mma.sync on one accumulator is not a float32 sum.
// float32 stays on mma.sync: wgmma takes TF32 operands only K-major, and
// three of the five products (dV = P^T dO, dK = dS^T Q, dQ = dS K) read an
// [S, D] operand along S, so dO, Q and K would each need a transposed copy
// in shared memory, beside a hi and a lo tile of each staged B operand
// (3xTF32): at 64 x 64 in float32, double-buffered, 256 KB for Q and dO in
// the dK/dV kernel, past the 227 KB a CTA may hold (ROADMAP.md).
// mma.sync fragments are gathered per thread, so either layout is read as
// it lies.
//
// Three kernels (float32; the bf16 section below shares the Delta kernel),
// no float atomics (two runs give the same bits, and remat's recomputation
// sees the same numbers):
//   * Delta, one warp a row;
//   * dK and dV: one CTA of four warps per (64-key tile, KV head, batch);
//     each warp owns 16 keys and computes S^T = K Q^T and dP^T = V dO^T in
//     registers, so P^T and dS^T are the A operands of dV and dK straight
//     from the accumulators (for TF32 the k index is permuted to match the
//     accumulator layout, and the B operand is read with the same
//     permutation).  The CTA loops over the group's H / KV query heads and
//     the q tiles that see its keys, so the GQA sum stays in registers;
//   * dQ: one CTA of four warps per (64-row q tile, head, batch), each warp
//     16 rows, over the KV tiles the forward visits.
// Both grids are linear with the tile index slowest, so the CTAs with the
// most steps (key tile 0, the last q tile) start first for every head and
// batch.  The streamed tiles (Q, dO, lse and Delta in the dK/dV kernel; K
// and V in the dQ kernel) are double-buffered with cp.async, so step it+1
// loads while step it computes.  Shared rows are padded by 16 bytes (4
// floats, 8 bf16): every fragment load, along a row (a row g, column t
// pattern) or across rows (rows 2t and 2t+1, column g), then touches 32
// distinct banks.
// Tiles, chosen by timing 64 and 32 for each kernel at B=8, H=32, KV=4,
// S=1024, D=64, float32, on the same card (kernel_timing.py
// flash-backward, -D REPRO_BWD_DKDV_BQ=32 or -D REPRO_BWD_DQ_BK=64): dK/dV
// 64 keys x 64 q rows a step (105 KB of shared memory in float32, two CTAs
// an SM; 32 q rows: 3.19 ms), dQ 64 q rows x 32 keys a step (70 KB, three
// CTAs an SM; 64 keys: 3.31 ms); for D = 128 the dK/dV step takes 32 q
// rows.
//
// Head dims.  The kernels are templates on Q's and K's head dim DK and V's,
// O's and dO's DV, as the forward is: S = Q K^T, dK = dS^T Q and dQ = dS K
// run at DK, dP = dO V^T and dV = P^T dO at DV, Delta = rowsum(dO o O) over
// DV, the scale 1/sqrt(DK).  Built for (32, 32), (64, 64) and (128, 128) in
// both types (those instances run the code above unchanged: one dK/dV
// launch, every product summed in one pass) and, in float32 only, for
// (256, 256) (gemma2-9b, recurrentgemma-9b) and MLA's (192, 128)
// (deepseek-v3).  The D <= 128 plan does not fit there: at D = 256 the
// dK/dV kernel would stage (2 * 64 + 4 * 32) rows of 260 floats, 266 KB
// against the 227 KB a CTA may opt into, and hold dK and dV, 64 keys x
// 256 x 2 floats over 128 threads, 256 registers a thread before anything
// else.  The plan above D = 128 (rows padded as above: 260 floats at 256,
// 196 and 132 at (192, 128)):
//   * dK/dV: still 64 keys a CTA, a warp 16 keys, but two launches: one
//     accumulates dV (S^T and P^T dO), the next dK (S^T, dP^T and dS^T Q),
//     so a thread holds one accumulator, 128 registers at 256 (dK 96, dV 64
//     at (192, 128)); 8 q rows a step, so S^T and dP^T take 4 registers
//     each; each step's product is summed 32 output columns at a time, 16
//     registers (add_product).  Shared memory: K (and V in the dK pass)
//     once, Q and dO twice, 8-row steps: at (256, 256) the dV pass 99,968
//     bytes (two CTAs an SM), the dK pass 166,528 (one); at (192, 128)
//     71,296 (three) and 105,088 (two).
//   * dQ: 64 q rows a CTA, 16 keys a step: Q and dO once, K and V twice,
//     199,680 bytes at (256, 256) and 125,952 at (192, 128), one CTA an
//     SM.  At DK = 256 the 64 x 256 accumulator is two launches of 128
//     columns each (dq_cols), each computing S and dP again: with one, it
//     spilled at 255 registers.
//   * S and dP are taken 64 columns of depth at a time in a loop ptxas does
//     not unroll (gemm_nt_bwd): fully unrolled, its fragment loads ahead
//     spilled.  Registers (ptxas, sm_90a): dV pass 167 and 96, dK pass 252
//     and 166, dQ 198 and 168 at (256, 256) and (192, 128), no spill
//     (chip_smoke.py checks the build log).  Built as variants on the card,
//     16 q rows a dK/dV step spilled as well, with 64, 32 or 8 columns
//     summed at a time and 64 or 32 columns of depth a step.
// S^T is computed in both dK/dV launches (and at DK = 256 S and dP in both
// dQ launches), so these instances run eight products (ten) where the
// bound counts five, on four to twelve warps an SM: they are far from
// their bound and behind the plain autograd (PERF.md), and right first.
// bfloat16 operands at these pairs are on no path (training weights are
// float32): the wrapper raises.
//
// What bounds it: operations.  The five causal products (QK^T, dV, dP, dQ,
// dK) are 5 * 2*B*H*S^2*D/2 = 8.6e10 operations at B=8, H=32, S=1024,
// D=64; as 3xTF32 they are three times that at 495 TFLOP/s, 0.52 ms (the
// bytes: 0.3 GB, 0.09 ms); in bf16 0.087 ms at 989 TFLOP/s.  This version
// computes seven products (the score and dP tiles in both kernels), and in
// float32 the instruction issue bounds it: each operand element costs three
// integer and float operations to split beside its share of three mma.sync.
// ---------------------------------------------------------------------------

struct BwdStrides {            // in elements; batch, head, sequence
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

// The two step tiles may be set with -D to time other choices.
#ifndef REPRO_BWD_DKDV_BQ
#define REPRO_BWD_DKDV_BQ 64
#endif
#ifndef REPRO_BWD_DQ_BK
#define REPRO_BWD_DQ_BK 32
#endif

constexpr int BWD_BK = 64;         // keys per dK/dV CTA
constexpr int BWD_BQ = 64;         // query rows per dQ CTA
constexpr int BWD_DQ_BK = REPRO_BWD_DQ_BK;   // keys a step of the dQ kernel

template <int DK, int DV>
__host__ __device__ constexpr int bwd_dmax() { return DK > DV ? DK : DV; }

// q rows a step of the dK/dV kernel
template <int DK, int DV>
__host__ __device__ constexpr int dkdv_bq() {
  return bwd_dmax<DK, DV>() <= 64 ? REPRO_BWD_DKDV_BQ
         : bwd_dmax<DK, DV>() <= 128 ? 32 : 8;
}

// keys a step of the dQ kernel
template <int DK, int DV>
__host__ __device__ constexpr int dq_bk() {
  return bwd_dmax<DK, DV>() <= 128 ? BWD_DQ_BK : 16;
}

// dQ columns a dQ launch accumulates: all of them up to DK = 192 (96
// registers), half above (a launch a half, each computing S and dP again).
template <int DK>
__host__ __device__ constexpr int dq_cols() {
  return DK <= 192 ? DK : DK / 2;
}

// What a dK/dV launch accumulates: both (up to D = 128), or, above it, dV
// in one launch and dK in a second (the large-D plan in the header).
enum BwdPass { BWD_BOTH, BWD_DV, BWD_DK };

template <int DK, int DV>
__host__ __device__ constexpr bool dkdv_split() {
  return bwd_dmax<DK, DV>() > 128;
}

template <typename T, int DK, int DV, int PASS>
constexpr size_t dkdv_smem_bytes() {
  // K, V (not in the dV pass); Q and dO twice; lse and Delta twice
  constexpr int BQ = dkdv_bq<DK, DV>();
  constexpr int VROWS = PASS == BWD_DV ? 0 : BWD_BK;
  return ((size_t)(BWD_BK + 2 * BQ) * row_ld<T, DK>()
          + (size_t)(VROWS + 2 * BQ) * row_ld<T, DV>()) * sizeof(T)
         + 4 * BQ * sizeof(float);
}

template <typename T, int DK, int DV>
constexpr size_t dq_smem_bytes() {
  // Q, dO; K and V twice
  constexpr int BK = dq_bk<DK, DV>();
  return ((size_t)(BWD_BQ + 2 * BK) * row_ld<T, DK>()
          + (size_t)(BWD_BQ + 2 * BK) * row_ld<T, DV>()) * sizeof(T);
}

// From the raw score s and dP: s becomes P (0 where masked), dp becomes dS.
__device__ __forceinline__ void p_and_ds(float& s, float& dp, float lse,
                                         float dl, bool keep, float cap,
                                         float scale) {
  float x = s * scale, dcap = 1.f;
  if (cap != 0.f) {
    const float th = tanhf(x / cap);
    x = cap * th;
    dcap = 1.f - th * th;
  }
  const float p = keep ? expf(x - lse) : 0.f;
  s = p;
  dp = p * (dp - dl) * dcap;
}

// n-tiles of a backward product summed apart at a time: all of them up to
// 128 columns, 32 columns above (16 registers a thread beside the
// accumulator's 96 or 128: with 64, as the forward's P V pass takes them,
// ptxas spilled the (256, 256) dK pass and both new dQ instances at 255
// registers).
template <int N>
__host__ __device__ constexpr int bwd_sum_tiles() {
  return N <= 16 ? N : 4;
}

// acc[j] += A B_j (j < NT) as gemm_nt over KD columns; above KD = 128 in
// a loop over 64 columns at a time that is not unrolled, so ptxas does not
// load the fragments of the whole depth ahead (at KD = 256 that spilled
// every new instance at 255 registers).  The products meet each
// accumulator in the same order either way.
template <typename T, int KD, int NT>
__device__ __forceinline__ void gemm_nt_bwd(float (&acc)[NT][4],
                                            const T* As, const T* Bs, int ld,
                                            int m, int g, int t) {
  if constexpr (KD <= 128) {
    gemm_nt<T, KD, NT>(acc, As, Bs, ld, m, g, t);
  } else {
    static_assert(KD % 64 == 0, "gemm_nt_bwd: KD a multiple of 64");
#pragma unroll 1
    for (int k = 0; k < KD; k += 64)
      gemm_nt<T, 64, NT>(acc, As + k, Bs + k, ld, m, g, t);
  }
}

// acc[j] += A B_j (j < N) as gemm_rn, each product summed apart and added
// to acc (add_to), bwd_sum_tiles<N> n-tiles a pass: all of them up to 128
// columns (one pass, gemm_rn then add_to as such).  Each output column
// sees the same products in the same order either way.
template <typename T, int N, int NA>
__device__ __forceinline__ void add_product(float (&acc)[N][4],
                                            const float (&a)[NA][4],
                                            const T* Bs, int ld, int g,
                                            int t) {
  constexpr int NC = bwd_sum_tiles<N>();
#pragma unroll
  for (int jc = 0; jc < N; jc += NC) {
    float part[NC][4];
    zero(part);
    gemm_rn<T, NC, NA>(part, a, Bs + 8 * jc, ld, g, t);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jc + j][e] += part[j][e];
  }
}

// Delta[b, h, s] = sum over V's head dim DV of dO * O, one warp a row.
template <typename T, int DV>
__global__ void __launch_bounds__(THREADS)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int H, int S,
                       long long rows, BwdStrides st) {
  const long long w = (blockIdx.x * (long long)THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= rows) return;
  const int s = w % S, h = (w / S) % H;
  const long long b = w / ((long long)S * H);
  const T* orow = o + b * st.o[0] + h * st.o[1] + s * st.o[2];
  const T* grow = dout + b * st.dout[0] + h * st.dout[1] + s * st.dout[2];
  float sum = 0.f;
  for (int d = lane; d < DV; d += 32)
    sum += to_f32(orow[d]) * to_f32(grow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[w] = sum;
}

// dK and dV (or, as PASS says, one of them) of one 64-key tile of one KV
// head, summed over the group's heads.  Warp w owns keys 16w..16w+15 of the
// tile.  S^T = K Q^T runs at DK, dP^T = V dO^T at DV, dV += P^T dO at DV
// and dK += dS^T Q at DK.
template <typename T, int DK, int DV, int PASS>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KV, int S, int window,
                      float cap, float scale, BwdStrides st) {
  constexpr int BQ = dkdv_bq<DK, DV>(), BK = BWD_BK;
  constexpr int LDK = row_ld<T, DK>(), LDV = row_ld<T, DV>();
  constexpr int NQ = BQ / 8, NDK = DK / 8, NDV = DV / 8;
  constexpr bool DO_DV = PASS != BWD_DK, DO_DK = PASS != BWD_DV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [BK][LDK]
  T* Vs = Ks + BK * LDK;                    // [BK][LDV], not in the dV pass
  T* Qs = Vs + (DO_DK ? BK * LDV : 0);      // [2][BQ][LDK]
  T* dOs = Qs + 2 * BQ * LDK;               // [2][BQ][LDV]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LDV);  // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                 // [2][BQ]

  // one linear grid, key tile slowest: the tiles that the most q tiles
  // see (tile 0 first) start first, for every head and batch
  const int nb = gridDim.x / (((S + BK - 1) / BK) * KV);   // batch size
  const int k_lo = (blockIdx.x / (KV * nb)) * BK;
  const int kvh = blockIdx.x % KV, b = (blockIdx.x / KV) % nb;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;

  // q tiles that see a key of this tile: from the one holding row k_lo to
  // the one holding the last row the window lets see the tile's last key;
  // steps run over (head of the group, q tile)
  const int nq = (S + BQ - 1) / BQ;
  const int k_hi = min(k_lo + BK - 1, S - 1);
  const int i_lo = k_lo / BQ;
  const int i_hi = window ? min(nq - 1, (k_hi + window - 1) / BQ) : nq - 1;
  const int n_it = i_hi - i_lo + 1, steps = G * n_it;

  auto stage = [&](int step) {
    const int h = kvh * G + step / n_it, q_lo = (i_lo + step % n_it) * BQ;
    const int buf = step & 1;
    stage_rows<T, DK, BQ>(Qs + buf * BQ * LDK, q + b * st.q[0] + h * st.q[1],
                          st.q[2], q_lo, S);
    stage_rows<T, DV, BQ>(dOs + buf * BQ * LDV,
                          dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                          q_lo, S);
    const long long off = ((long long)b * H + h) * S;
    stage_vec<BQ>(lse_s + buf * BQ, lse + off, q_lo, S);
    if constexpr (DO_DK) stage_vec<BQ>(dl_s + buf * BQ, delta + off, q_lo, S);
  };
  stage_rows<T, DK, BK>(Ks, k + b * st.k[0] + kvh * st.k[1], st.k[2], k_lo,
                        S);
  if constexpr (DO_DK)
    stage_rows<T, DV, BK>(Vs, v + b * st.v[0] + kvh * st.v[1], st.v[2], k_lo,
                          S);
  stage(0);
  cp_async_commit();

  float dk_acc[DO_DK ? NDK : 1][4], dv_acc[DO_DV ? NDV : 1][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) stage(step + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles have landed
    __syncthreads();
    const int buf = step & 1, q_lo = (i_lo + step % n_it) * BQ;
    const T* Qb = Qs + buf * BQ * LDK;
    const T* dOb = dOs + buf * BQ * LDV;
    const float* lb = lse_s + buf * BQ;
    const float* db = dl_s + buf * BQ;

    float s[NQ][4], dp[NQ][4];
    zero(s);
    zero(dp);
    gemm_nt_bwd<T, DK, NQ>(s, Ks, Qb, LDK, m, g, t);     // S^T = K Q^T
    if constexpr (DO_DK)
      gemm_nt_bwd<T, DV, NQ>(dp, Vs, dOb, LDV, m, g, t);   // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_lo + m + g + (e & 2 ? 8 : 0);
        const int c = 8 * j + 2 * t + (e & 1);     // q row in the tile
        p_and_ds(s[j][e], dp[j][e], lb[c], DO_DK ? db[c] : 0.f,
                 visible(q_lo + c, kpos, S, window), cap, scale);
      }
    // dV += P^T dO, then dK += dS^T Q, each step's product summed apart
    if constexpr (DO_DV) add_product<T, NDV, NQ>(dv_acc, s, dOb, LDV, g, t);
    if constexpr (DO_DK) add_product<T, NDK, NQ>(dk_acc, dp, Qb, LDK, g, t);
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  T* dkb = dk + b * st.dk[0] + kvh * st.dk[1];
  T* dvb = dv + b * st.dv[0] + kvh * st.dv[1];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = k_lo + m + g + (e & 2 ? 8 : 0);
    if (key >= S) continue;
    if constexpr (DO_DK) {
#pragma unroll
      for (int j = 0; j < NDK; ++j)
        store(&dkb[key * st.dk[2] + 8 * j + 2 * t + (e & 1)],
              dk_acc[j][e] * scale);
    }
    if constexpr (DO_DV) {
#pragma unroll
      for (int j = 0; j < NDV; ++j)
        store(&dvb[key * st.dv[2] + 8 * j + 2 * t + (e & 1)], dv_acc[j][e]);
    }
  }
}

// dQ of one 64-row q tile of one head, over the KV tiles the forward
// visits: its dq_cols<DK> columns from col0 on.  Warp w owns rows
// 16w..16w+15 of the tile.  S = Q K^T runs at DK, dP = dO V^T at DV, dQ +=
// dS K at DK.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int KV, int S, int window, float cap, float scale,
                    int col0, BwdStrides st) {
  constexpr int BQ = BWD_BQ, BK = dq_bk<DK, DV>();
  constexpr int LDK = row_ld<T, DK>(), LDV = row_ld<T, DV>();
  constexpr int NK = BK / 8, NDK = dq_cols<DK>() / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BQ][LDK]
  T* dOs = Qs + BQ * LDK;                   // [BQ][LDV]
  T* Ks = dOs + BQ * LDV;                   // [2][BK][LDK]
  T* Vs = Ks + 2 * BK * LDK;                // [2][BK][LDV]

  const int nq = (S + BQ - 1) / BQ;
  // one linear grid, q tile slowest: the last q tiles (the most KV tiles)
  // start first, for every head and batch
  const int nb = gridDim.x / (nq * H);                       // batch size
  const int q_lo = (nq - 1 - (int)(blockIdx.x / (H * nb))) * BQ;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % nb;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;

  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];
  const int q_hi = min(q_lo + BQ - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;
  auto stage = [&](int jt) {
    const int buf = (jt - j_lo) & 1;
    stage_rows<T, DK, BK>(Ks + buf * BK * LDK, kb, st.k[2], jt * BK, S);
    stage_rows<T, DV, BK>(Vs + buf * BK * LDV, vb, st.v[2], jt * BK, S);
  };
  stage_rows<T, DK, BQ>(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q_lo, S);
  stage_rows<T, DV, BQ>(dOs, dout + b * st.dout[0] + h * st.dout[1],
                        st.dout[2], q_lo, S);
  stage(j_lo);
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  float lse_r[2], dl_r[2];
  const long long off = ((long long)b * H + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + m + g + 8 * r;
    lse_r[r] = row < S ? lse[off + row] : 0.f;
    dl_r[r] = row < S ? delta[off + row] : 0.f;
  }

  float acc[NDK][4];
  zero(acc);

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    if (jt < j_hi) stage(jt + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles (and Q, dO) have landed
    __syncthreads();
    const int buf = (jt - j_lo) & 1, k_lo = jt * BK;
    const T* Kb = Ks + buf * BK * LDK;
    const T* Vb = Vs + buf * BK * LDV;

    float s[NK][4], dp[NK][4];
    zero(s);
    zero(dp);
    gemm_nt_bwd<T, DK, NK>(s, Qs, Kb, LDK, m, g, t);     // S = Q K^T
    gemm_nt_bwd<T, DV, NK>(dp, dOs, Vb, LDV, m, g, t);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
        p_and_ds(s[j][e], dp[j][e], lse_r[r], dl_r[r],
                 visible(q_lo + m + g + 8 * r, kpos, S, window), cap, scale);
      }
    add_product<T, NDK, NK>(acc, dp, Kb + col0, LDK, g, t);   // dQ += dS K
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  T* dqb = dq + b * st.dq[0] + h * st.dq[1] + col0;
#pragma unroll
  for (int j = 0; j < NDK; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q_lo + m + g + (e & 2 ? 8 : 0);
      if (row < S)
        store(&dqb[row * st.dq[2] + 8 * j + 2 * t + (e & 1)],
              acc[j][e] * scale);
    }
}

// ---------------------------------------------------------------------------
// The bfloat16 backward on wgmma (sm_90a).
//
// The dK/dV and dQ kernels above issue mma.sync m16n8k16 from four
// independent warps; on Hopper only wgmma reaches the tensor cores' full
// rate.  Here the same two kernels, with the same grids, steps and masks,
// issue their products as wgmma m64nNk16 from the CTA's one warpgroup (its
// four warps own rows 16w..16w+15 of the 64-row tile, the accumulator
// layout of mma.sync's m16n8 tiles, so the work between the products keeps
// its form; dQ's step is 64 keys):
//   * dK/dV: S^T = K Q^T and dP^T = V dO^T with K, V as the A operand and
//     Q, dO as B, all K-major from shared memory; P^T and dS^T, rounded to
//     bf16 in registers, are the register A operand of dV += P^T dO and
//     dK += dS^T Q, whose B (dO, Q) is read MN-major with the transpose
//     flag: no transposed copies.
//   * dQ: S = Q K^T and dP = dO V^T from shared memory; dQ += dS K with dS
//     in registers and K read MN-major.
// A [R, D] tile is staged by cp.async into the swizzled layout the
// descriptors name: rows of 128 bytes (a 64-wide panel; D = 128 is two
// panels) with the 128-byte swizzle, or of 64 bytes (D = 32) with the
// 64-byte swizzle, each tile on a 1,024-byte boundary.  A K-major operand's
// 16-deep k step starts 32 bytes further into the swizzled rows; an
// MN-major operand's k step is 16 rows further on, and each wgmma reads one
// panel of D (N = 64 or 32), so the stride between panels is never used.
// The streamed tiles are double-buffered as in the kernels above
// (cp.async groups: step s + 1 loads while step s computes), then fenced
// for the async proxy that wgmma reads through.  Staging with TMA and
// mbarriers fed by a producer warp was not built or timed.
// Each step's products are summed apart (scale-d 0 on the first k step)
// and added to dK, dV and dQ in float32 (add_to), seven products as
// before, no float atomics: two runs give the same bits.
// What was timed (kernel_timing.py flash-backward at B=8, H=32, KV=4,
// S=1024, D=64, bf16, versions in turns in one call each; NVIDIA H100
// 80GB HBM3, 700 W): mma.sync 1.390 ms; these kernels with p_and_ds's
// accurate expf 1.19 (dK/dV 0.695, dQ 0.435 by the profiler); with the
// exponential as one ex2.approx and the mask skipped on steps every pair
// of which is visible, 0.649; with the score scale, log2(e) and lse folded
// into one FFMA and the soft-cap a compile-time case (below), 0.598 (dK/dV
// 0.316, dQ 0.218, Delta 0.063).  The elementwise work, not the products,
// bounds them.  Not kept, not in this source: P computed while the dP
// product is in flight (two commit groups), 0.72 against 0.65; a register
// budget for 2 or 3 CTAs an SM (__launch_bounds__), 1.19 and 1.22 against
// 1.19; dV and dK issued one after the other, 1.19 against 1.19.
// ---------------------------------------------------------------------------

namespace wg {

using bf16 = __nv_bfloat16;

// d (64 x 32) += A B, A and B read from shared memory by descriptor;
// tB: B is MN-major; scale_d 0: d is discarded first.
template <int tB>
__device__ __forceinline__ void wgmma_ss32(float (&d)[16],
                                        unsigned long long a,
                                        unsigned long long b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(tB));
}

// d (64 x 64) += A B, A and B read from shared memory by descriptor;
// tB: B is MN-major; scale_d 0: d is discarded first.
template <int tB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32],
                                        unsigned long long a,
                                        unsigned long long b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(tB));
}

// d (64 x 32) += A B: A from registers (four bf16 pairs a thread, the
// layout of mma.sync's m16n8k16 A for each warp's 16 rows), B from shared
// memory; tB: B is MN-major; scale_d 0: d is discarded first.
template <int tB>
__device__ __forceinline__ void wgmma_rs32(float (&d)[16],
                                        const unsigned (&a)[4],
                                        unsigned long long b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(tB));
}

// d (64 x 64) += A B: A from registers (four bf16 pairs a thread, the
// layout of mma.sync's m16n8k16 A for each warp's 16 rows), B from shared
// memory; tB: B is MN-major; scale_d 0: d is discarded first.
template <int tB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                        const unsigned (&a)[4],
                                        unsigned long long b,
                                        int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(tB));
}

template <int N, int tB>
__device__ __forceinline__ void mma_ss(float (&d)[N / 8][4],
                                       unsigned long long a,
                                       unsigned long long b, int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma N");
  auto& f = *reinterpret_cast<float(*)[N / 2]>(&d[0][0]);
  if constexpr (N == 32) wgmma_ss32<tB>(f, a, b, scale_d);
  else wgmma_ss64<tB>(f, a, b, scale_d);
}

template <int N, int tB>
__device__ __forceinline__ void mma_rs(float (&d)[N / 8][4],
                                       const unsigned (&a)[4],
                                       unsigned long long b, int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma N");
  auto& f = *reinterpret_cast<float(*)[N / 2]>(&d[0][0]);
  if constexpr (N == 32) wgmma_rs32<tB>(f, a, b, scale_d);
  else wgmma_rs64<tB>(f, a, b, scale_d);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// cp.async's shared-memory writes, made visible to wgmma's async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keep the compiler from moving accesses of registers that an in-flight
// wgmma writes (or reads) across its issue or its wait.
template <int N>
__device__ __forceinline__ void hold(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[j][e])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(unsigned (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

constexpr float LOG2E = 1.4426950408889634f;

// p_and_ds for the bf16 kernels, with the exponential as one ex2.approx
// (relative error ~2^-22, far inside bf16's): P = 2^(x log2 e - lse_l2),
// lse_l2 = lse log2 e; without a soft-cap (kCap false) x log2 e - lse_l2 is
// one FFMA of the raw score (scale_l2 = scale log2 e).  The elementwise
// work between the products bounds these kernels more than the products
// do: the accurate expf took the training shape's backward from 0.65 to
// 1.19 ms (kernel_timing.py flash-backward, one call; NVIDIA H100 80GB
// HBM3, 700 W).
template <bool kCap>
__device__ __forceinline__ void p_and_ds_bf16(float& s, float& dp,
                                              float lse_l2, float dl,
                                              bool keep, float cap,
                                              float scale, float scale_l2) {
  float y, dcap = 1.f;
  if constexpr (kCap) {
    const float th = tanhf(s * scale / cap);
    dcap = 1.f - th * th;
    y = cap * th * LOG2E - lse_l2;
  } else {
    y = fmaf(s, scale_l2, -lse_l2);
  }
  float p = 0.f;
  if (keep) asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(y));
  s = p;
  dp = kCap ? p * (dp - dl) * dcap : p * (dp - dl);
}

// Runs f(kSeen, kCap) with both as compile-time constants: the elementwise
// loops come in four instances, none testing the mask or the cap per
// element where it need not.
template <typename F>
__device__ __forceinline__ void with_flags(bool seen, bool capped, F&& f) {
  if (seen) {
    if (capped) f(std::true_type(), std::true_type());
    else f(std::true_type(), std::false_type());
  } else {
    if (capped) f(std::false_type(), std::true_type());
    else f(std::false_type(), std::false_type());
  }
}

// A staged [R, D] tile: panels of PW columns, rows of PW * 2 bytes.
template <int D>
__host__ __device__ constexpr int panel() { return D >= 64 ? 64 : 32; }
// the descriptor's layout type: 1 = 128-byte swizzle, 2 = 64-byte
template <int D>
__host__ __device__ constexpr unsigned long long swizzle_mode() {
  return D >= 64 ? 1ull : 2ull;
}

// Byte offset of 16-byte chunk c16 (of D / 8) of row r in a tile of R rows
// whose base lies on a 1,024-byte boundary: the chunk index XORed with row
// bits, as the hardware swizzles the address.
template <int D, int R>
__device__ __forceinline__ int tile_off(int r, int c16) {
  constexpr int PB = 2 * panel<D>(), CPP = PB / 16;
  const int p = c16 / CPP, cc = c16 % CPP;
  const int sw = PB == 128 ? (r & 7) : ((r >> 1) & 3);
  return p * R * PB + r * PB + ((cc ^ sw) << 4);
}

// R rows of a [.., S, D] operand (row `lo` on) into a swizzled tile, zeros
// past S.
template <int D, int R>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long stride, int lo, int S) {
  constexpr int CPR = D / 8;
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
  for (int c = threadIdx.x; c < R * CPR; c += TC_THREADS) {
    const int r = c / CPR, col = c % CPR, row = lo + r;
    const bool in = row < S;
    cp_async16(base + tile_off<D, R>(r, col),
               in ? src + row * stride + col * 8 : src, in);
  }
}

__device__ __forceinline__ unsigned long long make_desc(
    const void* p, unsigned lbo, unsigned sbo, unsigned long long mode) {
  return (unsigned long long)((smem_addr(p) & 0x3ffffu) >> 4)
         | ((unsigned long long)((lbo >> 4) & 0x3fffu) << 16)
         | ((unsigned long long)((sbo >> 4) & 0x3fffu) << 32)
         | (mode << 62);
}

// K-major operand (A, or B read along its rows): k step ks (columns
// 16ks..16ks+15) of an [R, D] tile; 8-row groups 8 * PB bytes apart.
template <int D, int R>
__device__ __forceinline__ unsigned long long desc_k(const bf16* tile,
                                                     int ks) {
  constexpr int PW = panel<D>(), PB = 2 * PW;
  const int e = 16 * ks;
  return make_desc(reinterpret_cast<const unsigned char*>(tile)
                       + (e / PW) * R * PB + (e % PW) * 2,
                   16, 8 * PB, swizzle_mode<D>());
}

// MN-major B: rows 16ks..16ks+15 of an [R, D] tile (the product's k) and
// panel p of its columns (its n); 8-row groups 8 * PB bytes apart.  A
// wgmma reads one panel (N = the swizzle's width), so the stride between
// MN blocks is never taken: both offsets hold the 8-row stride.
template <int D, int R>
__device__ __forceinline__ unsigned long long desc_mn(const bf16* tile,
                                                      int ks, int p) {
  constexpr int PB = 2 * panel<D>();
  return make_desc(reinterpret_cast<const unsigned char*>(tile)
                       + p * R * PB + 16 * ks * PB,
                   8 * PB, 8 * PB, swizzle_mode<D>());
}

// The A operand of k step i from accumulator tiles 2i and 2i + 1, rounded
// to bf16 (Tc<bf16>::a_from_acc).
template <int N>
__device__ __forceinline__ void to_a(unsigned (&a)[N / 2][4],
                                     const float (&c)[N][4]) {
  using O = Tc<bf16>;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const typename O::A f = O::a_from_acc(c, i);
#pragma unroll
    for (int e = 0; e < 4; ++e) a[i][e] = f.r[e];
  }
}

// acc's panel p += A B, A from registers (R / 16 k steps of the product),
// B the MN-major [R, D] tile; the product summed apart, then added in
// float32.
template <int D, int R, int PW, int ND>
__device__ __forceinline__ void product_into(float (&acc)[ND][4],
                                             unsigned (&a)[R / 16][4],
                                             const bf16* tile, int p) {
  constexpr int NPW = PW / 8;
  float part[NPW][4];
  zero(part);
  hold(part);
  fence();
#pragma unroll
  for (int i = 0; i < R / 16; ++i)
    mma_rs<PW, 1>(part, a[i], desc_mn<D, R>(tile, i, p), i);
  commit();
  wait_all();
  hold(part);
  hold(a);
#pragma unroll
  for (int j = 0; j < NPW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[p * NPW + j][e] += part[j][e];
}

// q rows a step of the dK/dV kernel; keys a step of the dQ kernel
template <int D>
__host__ __device__ constexpr int dkdv_bq() { return D <= 64 ? 64 : 32; }
constexpr int DQ_BK = 64;

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<unsigned long long>(p) + 1023ull) & ~1023ull);
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // 1 KB to align; K, V; Q and dO twice; lse and Delta twice
  return 1024 + (size_t)(2 * BWD_BK + 4 * dkdv_bq<D>()) * D * 2
         + 4 * dkdv_bq<D>() * sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // 1 KB to align; Q, dO; K and V twice
  return 1024 + (size_t)(2 * BWD_BQ + 4 * DQ_BK) * D * 2;
}

// dK and dV of one 64-key tile of one KV head, summed over the group's
// heads (flash_bwd_dkdv_kernel's grid and steps).
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int KV,
            int S, int window, float cap, float scale, BwdStrides st) {
  constexpr int BQ = dkdv_bq<D>(), BK = BWD_BK;
  constexpr int NQ = BQ / 8, ND = D / 8, PW = panel<D>(), NP = D / PW;
  constexpr int NPW = PW / 8, KS = D / 16, QS = BQ / 16;
  extern __shared__ unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(align1k(smem_raw));   // [BK, D]
  bf16* Vs = Ks + BK * D;                                  // [BK, D]
  bf16* Qs = Vs + BK * D;                                  // [2][BQ, D]
  bf16* dOs = Qs + 2 * BQ * D;                             // [2][BQ, D]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * D);   // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int nb = gridDim.x / (((S + BK - 1) / BK) * KV);   // batch size
  const int k_lo = (blockIdx.x / (KV * nb)) * BK;
  const int kvh = blockIdx.x % KV, b = (blockIdx.x / KV) % nb;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;

  const int nq = (S + BQ - 1) / BQ;
  const int k_hi = min(k_lo + BK - 1, S - 1);
  const int i_lo = k_lo / BQ;
  const int i_hi = window ? min(nq - 1, (k_hi + window - 1) / BQ) : nq - 1;
  const int n_it = i_hi - i_lo + 1, steps = G * n_it;

  auto stage = [&](int step) {
    const int h = kvh * G + step / n_it, q_lo = (i_lo + step % n_it) * BQ;
    const int buf = step & 1;
    stage_tile<D, BQ>(Qs + buf * BQ * D, q + b * st.q[0] + h * st.q[1],
                      st.q[2], q_lo, S);
    stage_tile<D, BQ>(dOs + buf * BQ * D,
                      dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                      q_lo, S);
    const long long off = ((long long)b * H + h) * S;
    stage_vec<BQ>(lse_s + buf * BQ, lse + off, q_lo, S);
    stage_vec<BQ>(dl_s + buf * BQ, delta + off, q_lo, S);
  };
  stage_tile<D, BK>(Ks, k + b * st.k[0] + kvh * st.k[1], st.k[2], k_lo, S);
  stage_tile<D, BK>(Vs, v + b * st.v[0] + kvh * st.v[1], st.v[2], k_lo, S);
  stage(0);
  cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
  zero(dk_acc);
  zero(dv_acc);
  const float scale_l2 = scale * LOG2E;

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) stage(step + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles have landed
    fence_async_smem();
    __syncthreads();
    const int buf = step & 1, q_lo = (i_lo + step % n_it) * BQ;
    const bf16* Qb = Qs + buf * BQ * D;
    const bf16* dOb = dOs + buf * BQ * D;
    const float* lb = lse_s + buf * BQ;
    const float* db = dl_s + buf * BQ;

    float s[NQ][4], dp[NQ][4];                 // S^T = K Q^T, dP^T = V dO^T
    zero(s);
    zero(dp);
    hold(s);
    hold(dp);
    fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma_ss<BQ, 0>(s, desc_k<D, BK>(Ks, ks), desc_k<D, BQ>(Qb, ks), ks);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma_ss<BQ, 0>(dp, desc_k<D, BK>(Vs, ks), desc_k<D, BQ>(dOb, ks), ks);
    commit();
    wait_all();
    hold(s);
    hold(dp);
    // a step whose every q row sees every key of the tile skips the mask
    const bool seen = q_lo >= k_lo + BK - 1 && q_lo + BQ <= S
                      && (!window || q_lo + BQ - 1 - k_lo < window);
    with_flags(seen, cap != 0.f, [&](auto all_seen, auto capped) {
      float l2[NQ][2];              // lse log2 e of this thread's q rows
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) l2[j][i] = lb[8 * j + 2 * t + i] * LOG2E;
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k_lo + m + g + (e & 2 ? 8 : 0);
          const int c = 8 * j + 2 * t + (e & 1);   // q row in the tile
          p_and_ds_bf16<decltype(capped)::value>(
              s[j][e], dp[j][e], l2[j][e & 1], db[c],
              decltype(all_seen)::value
                  || visible(q_lo + c, kpos, S, window),
              cap, scale, scale_l2);
        }
    });
    // dV += P^T dO and dK += dS^T Q, a panel of D at a time, each step's
    // products summed apart
    unsigned pa[QS][4], da[QS][4];
    to_a(pa, s);
    to_a(da, dp);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float pv[NPW][4], pk[NPW][4];
      zero(pv);
      zero(pk);
      hold(pv);
      hold(pk);
      fence();
#pragma unroll
      for (int i = 0; i < QS; ++i)
        mma_rs<PW, 1>(pv, pa[i], desc_mn<D, BQ>(dOb, i, p), i);
#pragma unroll
      for (int i = 0; i < QS; ++i)
        mma_rs<PW, 1>(pk, da[i], desc_mn<D, BQ>(Qb, i, p), i);
      commit();
      wait_all();
      hold(pv);
      hold(pk);
      hold(pa);
      hold(da);
#pragma unroll
      for (int j = 0; j < NPW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv_acc[p * NPW + j][e] += pv[j][e];
          dk_acc[p * NPW + j][e] += pk[j][e];
        }
    }
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  bf16* dkb = dk + b * st.dk[0] + kvh * st.dk[1];
  bf16* dvb = dv + b * st.dv[0] + kvh * st.dv[1];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k_lo + m + g + (e & 2 ? 8 : 0);
      const int c = 8 * j + 2 * t + (e & 1);
      if (key < S) {
        store(&dkb[key * st.dk[2] + c], dk_acc[j][e] * scale);
        store(&dvb[key * st.dv[2] + c], dv_acc[j][e]);
      }
    }
}

// dQ of one 64-row q tile of one head (flash_bwd_dq_kernel's grid), over
// the KV tiles the forward visits, 64 keys a step.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, int H, int KV, int S, int window, float cap,
          float scale, BwdStrides st) {
  constexpr int BQ = BWD_BQ, BK = DQ_BK;
  constexpr int NK = BK / 8, ND = D / 8, PW = panel<D>(), NP = D / PW;
  constexpr int NPW = PW / 8, KS = D / 16, BS = BK / 16;
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1k(smem_raw));   // [BQ, D]
  bf16* dOs = Qs + BQ * D;                                 // [BQ, D]
  bf16* Ks = dOs + BQ * D;                                 // [2][BK, D]
  bf16* Vs = Ks + 2 * BK * D;                              // [2][BK, D]

  const int nq = (S + BQ - 1) / BQ;
  const int nb = gridDim.x / (nq * H);                       // batch size
  const int q_lo = (nq - 1 - (int)(blockIdx.x / (H * nb))) * BQ;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % nb;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;

  const bf16* kb = k + b * st.k[0] + kvh * st.k[1];
  const bf16* vb = v + b * st.v[0] + kvh * st.v[1];
  const int q_hi = min(q_lo + BQ - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;
  auto stage = [&](int jt) {
    const int buf = (jt - j_lo) & 1;
    stage_tile<D, BK>(Ks + buf * BK * D, kb, st.k[2], jt * BK, S);
    stage_tile<D, BK>(Vs + buf * BK * D, vb, st.v[2], jt * BK, S);
  };
  stage_tile<D, BQ>(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q_lo, S);
  stage_tile<D, BQ>(dOs, dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                    q_lo, S);
  stage(j_lo);
  cp_async_commit();

  float lse_l2[2], dl_r[2];                   // lse log2 e, Delta
  const long long off = ((long long)b * H + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + m + g + 8 * r;
    lse_l2[r] = row < S ? lse[off + row] * LOG2E : 0.f;
    dl_r[r] = row < S ? delta[off + row] : 0.f;
  }
  const float scale_l2 = scale * LOG2E;

  float acc[ND][4];
  zero(acc);

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    if (jt < j_hi) stage(jt + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles (and Q, dO) have landed
    fence_async_smem();
    __syncthreads();
    const int buf = (jt - j_lo) & 1, k_lo = jt * BK;
    const bf16* Kb = Ks + buf * BK * D;
    const bf16* Vb = Vs + buf * BK * D;

    float s[NK][4], dp[NK][4];                 // S = Q K^T, dP = dO V^T
    zero(s);
    zero(dp);
    hold(s);
    hold(dp);
    fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma_ss<BK, 0>(s, desc_k<D, BQ>(Qs, ks), desc_k<D, BK>(Kb, ks), ks);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma_ss<BK, 0>(dp, desc_k<D, BQ>(dOs, ks), desc_k<D, BK>(Vb, ks), ks);
    commit();
    wait_all();
    hold(s);
    hold(dp);
    // a step where every q row of the tile sees every key skips the mask
    const bool seen = k_lo + BK - 1 <= q_lo && k_lo + BK <= S
                      && q_lo + BQ <= S
                      && (!window || q_lo + BQ - 1 - k_lo < window);
    with_flags(seen, cap != 0.f, [&](auto all_seen, auto capped) {
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
          p_and_ds_bf16<decltype(capped)::value>(
              s[j][e], dp[j][e], lse_l2[r], dl_r[r],
              decltype(all_seen)::value
                  || visible(q_lo + m + g + 8 * r, kpos, S, window),
              cap, scale, scale_l2);
        }
    });
    unsigned da[BS][4];                        // dQ += dS K, a panel a time
    to_a(da, dp);
#pragma unroll
    for (int p = 0; p < NP; ++p) product_into<D, BK, PW>(acc, da, Kb, p);
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  bf16* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q_lo + m + g + (e & 2 ? 8 : 0);
      if (row < S)
        store(&dqb[row * st.dq[2] + 8 * j + 2 * t + (e & 1)],
              acc[j][e] * scale);
    }
}

// The dK/dV and dQ kernels in bf16, after the Delta kernel.
template <int D>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v,
                   const bf16* dout, const float* lse, const float* delta,
                   bf16* dq, bf16* dk, bf16* dv, int B, int H, int KV, int S,
                   int window, float cap, float scale, const BwdStrides& st,
                   cudaStream_t stream) {
  const size_t kv_bytes = dkdv_smem_bytes<D>();
  const size_t q_bytes = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_bytes);
  if (err != cudaSuccess) return err;
  const unsigned kv_ctas = (S + BWD_BK - 1) / BWD_BK * KV * B;
  const unsigned q_ctas = (S + BWD_BQ - 1) / BWD_BQ * H * B;
  dkdv_kernel<D><<<kv_ctas, TC_THREADS, kv_bytes, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, KV, S, window, cap, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<D><<<q_ctas, TC_THREADS, q_bytes, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KV, S, window, cap, scale, st);
  return cudaGetLastError();
}

}  // namespace wg

template <typename T, int DK, int DV, int PASS>
cudaError_t launch_dkdv(const T* q, const T* k, const T* v, const T* dout,
                        const float* lse, const float* delta, T* dk, T* dv,
                        int B, int H, int KV, int S, int window, float cap,
                        float scale, const BwdStrides& st,
                        cudaStream_t stream) {
  const size_t bytes = dkdv_smem_bytes<T, DK, DV, PASS>();
  auto kernel = flash_bwd_dkdv_kernel<T, DK, DV, PASS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const unsigned ctas = (S + BWD_BK - 1) / BWD_BK * KV * B;
  kernel<<<ctas, TC_THREADS, bytes, stream>>>(q, k, v, dout, lse, delta, dk,
                                              dv, H, KV, S, window, cap,
                                              scale, st);
  return cudaGetLastError();
}

template <typename T, int DK, int DV>
cudaError_t launch_backward(const void* q_, const void* k_, const void* v_,
                            const void* o, const void* dout_,
                            const float* lse, float* delta, void* dq_,
                            void* dk_, void* dv_, int B, int H, int KV,
                            int S, int window, float cap,
                            const BwdStrides& st, cudaStream_t stream) {
  const T* q = static_cast<const T*>(q_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const T* dout = static_cast<const T*>(dout_);
  T* dq = static_cast<T*>(dq_);
  T* dk = static_cast<T*>(dk_);
  T* dv = static_cast<T*>(dv_);
  const long long rows = (long long)B * H * S;
  const unsigned delta_blocks =
      static_cast<unsigned>((rows * 32 + THREADS - 1) / THREADS);
  flash_bwd_delta_kernel<T, DV><<<delta_blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), dout, delta, H, S, rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)DK));
  if constexpr (sizeof(T) == 2) {       // bf16: the wgmma kernels above
    static_assert(DK == DV && DK <= 128, "bf16 backward: D <= 128, Dk == Dv");
    return wg::launch<DK>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, S,
                          window, cap, scale, st, stream);
  } else {     // float32: 3xTF32 on mma.sync
    if constexpr (dkdv_split<DK, DV>()) {
      err = launch_dkdv<T, DK, DV, BWD_DV>(q, k, v, dout, lse, delta, dk, dv,
                                           B, H, KV, S, window, cap, scale,
                                           st, stream);
      if (err != cudaSuccess) return err;
      err = launch_dkdv<T, DK, DV, BWD_DK>(q, k, v, dout, lse, delta, dk, dv,
                                           B, H, KV, S, window, cap, scale,
                                           st, stream);
    } else {
      err = launch_dkdv<T, DK, DV, BWD_BOTH>(q, k, v, dout, lse, delta, dk,
                                             dv, B, H, KV, S, window, cap,
                                             scale, st, stream);
    }
    if (err != cudaSuccess) return err;
    const size_t q_bytes = dq_smem_bytes<T, DK, DV>();
    auto dqk = flash_bwd_dq_kernel<T, DK, DV>;
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_bytes);
    if (err != cudaSuccess) return err;
    const unsigned q_ctas = (S + BWD_BQ - 1) / BWD_BQ * H * B;
    for (int col0 = 0; col0 < DK; col0 += dq_cols<DK>()) {
      dqk<<<q_ctas, TC_THREADS, q_bytes, stream>>>(
          q, k, v, dout, lse, delta, dq, H, KV, S, window, cap, scale, col0,
          st);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
  }
}

// The (DK, DV) pairs the backward is built for: the square ones up to 128
// in both types, and in float32 also (256, 256) and MLA's (192, 128).
// ops.BWD_HEAD_DIMS lists the same float32 pairs.
template <typename T>
cudaError_t dispatch_backward(int DK, int DV, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int B, int H, int KV, int S,
                              int window, float cap, const BwdStrides& st,
                              cudaStream_t stream) {
#define REPRO_BWD_CASE(dk_, dv_)                                            \
  if (DK == dk_ && DV == dv_)                                               \
    return launch_backward<T, dk_, dv_>(q, k, v, o, dout, lse, delta, dq,   \
                                        dk, dv, B, H, KV, S, window, cap,   \
                                        st, stream);
  REPRO_BWD_CASE(32, 32)
  REPRO_BWD_CASE(64, 64)
  REPRO_BWD_CASE(128, 128)
  if constexpr (sizeof(T) == 4) {
    REPRO_BWD_CASE(256, 256)
    REPRO_BWD_CASE(192, 128)
  }
#undef REPRO_BWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q: [B, H, S, D]; k: [B, KV, S, D]; v: [B, KV, S, Dv]; o: [B, H, S, Dv],
// (D, Dv) one of the pairs `dispatch` lists; addressed through `strides`
// (12 int64: batch, head and sequence strides of q, k, v, o, in elements;
// the head dimension is contiguous).  dtype 0 = float32, 1 = bfloat16.
// lse: null, or float32 [B, H, S] (contiguous) for each row's log-sum-exp.
// Returns the launch's cudaGetLastError() (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, void* lse, int dtype, int B, int H, int KV,
                          int S, int D, int Dv, int window, float cap,
                          const long long* strides, void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err =
      dtype == 0
          ? dispatch<float>(D, Dv, q, k, v, o, l, B, H, KV, S, window, cap,
                            st, s)
          : dtype == 1 ? dispatch<__nv_bfloat16>(D, Dv, q, k, v, o, l, B, H,
                                                 KV, S, window, cap, st, s)
                       : cudaErrorInvalidValue;
  return (int)err;
}

// q, dq: [B, H, S, D]; k, dk: [B, KV, S, D]; v, dv: [B, KV, S, Dv]; o,
// dout: [B, H, S, Dv], (D, Dv) one of the pairs `dispatch_backward` lists
// for the dtype; addressed through `strides` (24 int64: batch, head and
// sequence strides of q, k, v, o, dout, dq, dk, dv, in elements; the head
// dimension is contiguous).  lse: the forward's float32 [B, H, S]; delta:
// float32 scratch [B, H, S].  dtype 0 = float32, 1 = bfloat16 (every
// operand; lse and delta float32).  Returns the last launch's
// cudaGetLastError() (0 on success).
int repro_flash_attention_backward(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int dtype, int B, int H, int KV, int S,
                                   int D, int Dv, int window, float cap,
                                   const long long* strides, void* stream) {
  BwdStrides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err =
      dtype == 0 ? dispatch_backward<float>(D, Dv, q, k, v, o, dout, l, dl,
                                            dq, dk, dv, B, H, KV, S, window,
                                            cap, st, s)
      : dtype == 1 ? dispatch_backward<__nv_bfloat16>(
                         D, Dv, q, k, v, o, dout, l, dl, dq, dk, dv, B, H, KV,
                         S, window, cap, st, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
