// Causal GQA flash attention for Hopper (sm_90a): the forward kernel and,
// below it, the backward kernels, all on the tensor cores: float32 as
// 3xTF32 on mma.sync, the bf16 forward on mma.sync (on wgmma at MLA's
// (192, 128): namespace wgf), the bf16 backward on wgmma (its own
// section, namespace wg).
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
// two versions in turns in one call; NVIDIA H100 80GB HBM3, 700 W).
//
// The bfloat16 forward on wgmma (namespace wgf, below the wg section;
// ops.forward_plan routes bf16 at MLA's (192, 128) to it, where the
// mma.sync kernel lost most to SDPA; built at (64, 64), (128, 128) and
// (256, 256) too, timed there, not routed).  A CTA of three warpgroups
// (two at DV = 256), each 64 q rows, on a head-major grid: a head's q tiles
// run side by side and share its K and V tiles in L2, and the CTA's
// warpgroups share each staged tile.  Per KV tile of 64 keys (32 at DV =
// 256), each warpgroup: S = Q K^T as wgmma m64nBKk16 from shared memory
// (Q and K K-major, 128-byte swizzle, the wg section's descriptors); the
// online softmax in the accumulator's row layout, base 2 (the score scale
// and log2 e folded in; on tiles every row sees whole and uncapped, the
// exponent's argument one FFMA of the raw score), the mask only on tiles
// the warpgroup does not see whole, a tile it sees none of skipped; then
// O = O corr + P V a 64-wide panel of O at a time, P rounded to bf16 in
// registers (the register-A form) and V read MN-major with the transpose
// flag.  K and V are double-buffered by cp.async.  Each product lands in
// a fresh accumulator and is added to O in float32 (as the backward's
// wgmma kernels do): with O itself the accumulator of P V, rescaled
// between products, ptxas serialized every wgmma of the kernel (C7515,
// "non wgmma instructions defining accumulator registers").  What was
// timed at deepseek-v3's [8, 128, KV 128, 1024] (CUDA events, the
// mma.sync kernel 2.26-2.32 ms in the same calls; NVIDIA H100 80GB HBM3,
// 700 W; the bytes bound 0.401 ms, SDPA 0.73): one warpgroup a CTA, two
// CTAs an SM, q-tile-major grid, O as the accumulator: 2.10 ms; two and
// three warpgroups sharing K and V, head-major: 1.71 and 1.50 (cutting
// the softmax, the S product or the K and V loads from that one each
// saved 0.3-0.4 ms: they run one after the other); S of the next tile
// issued before the softmax (FA3's overlap), serialized by C7515: 1.85;
// fresh accumulators (this version): 1.43-1.45 (two warpgroups 1.60);
// with a three-slot ring staged two tiles ahead and one barrier a tile:
// 1.50; with fresh accumulators and the overlap (two warpgroups, 255
// registers, spilling): 1.77; the warpgroups' S issued in turn (named
// barriers, FA3's ping-pong; spilling): 1.87.  Three warpgroups hold 168
// registers a thread, no spill; the (256, 256) instance spills 172 bytes
// (not routed).  Still 3.6x its bound: the warpgroups wait on their
// products, the tensor cores idle through the softmax; TMA and a producer
// warp, freeing the registers an overlap needs, are the next step.
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
// dK/dV kernel would stage 266 KB against the 227 KB a CTA may opt into,
// and hold dK and dV over four warps, 256 registers a thread.  The wide
// plan (section "The float32 backward at (256, 256) and (192, 128)"):
//   * one dK/dV launch, eight warps a CTA in two roles of four: each step
//     role 0 computes S^T = K Q^T over DK and turns it into P^T, role 1
//     dP^T = V dO^T over DV and, from role 0's P dcap (shared memory),
//     dS^T; P^T and dS^T are staged in shared memory split into hi and lo
//     once (their columns paired, wide_col, so an A fragment is one 8-byte
//     load); then each role-0 warp adds P^T dO into DV / 4 columns of dV
//     and each role-1 warp dS^T Q into DK / 4 columns of dK, all the
//     tile's keys.  The split balances: at (192, 128) role 0's deeper S^T
//     (192) goes with dV's 4 n tiles a warp, role 1's dP^T (128) with
//     dK's 6.  32 keys a CTA and 32 q rows a step (227,840 and 154,112 B
//     of shared memory, 233 and 205 registers at (256, 256) and (192,
//     128)): with 64 keys dK and dV take 128 registers a thread at (256,
//     256) and ptxas spilled 624 bytes; at (192, 128) 64 keys and 16 rows
//     a step took 36.88-37.21 ms, 32 and 32 36.20-36.21 (the same call);
//   * one dQ launch (at DK = 256 too), eight warps a CTA of 64 q rows: role
//     0 computes S = Q K^T and P dcap, role 1 dP = dO V^T and dS (staged
//     split); then every warp adds dS K into DK / 8 columns of dQ.  16
//     keys a step at (256, 256) (219,136 B, 204 registers), 32 at (192,
//     128) (the tiles fit; 194 registers);
//   * S and dP are read two depth columns at a time (8-byte loads, rows
//     padded by 8 floats: 32 banks a half warp), their three 3xTF32 terms
//     in accumulators of their own (three independent mma.sync chains an
//     n tile: gemma2's dK/dV 5.34 -> 4.77 ms, then 3.95 with the 32-key
//     tiles); each step's product is summed apart and added in float32,
//     as above;
//   * the staging code reads the thread index afresh at each step
//     (fresh_tid): the addresses ptxas hoisted out of the step loop spilled
//     the (192, 128) dK/dV kernel.
// No spill (chip_smoke.py checks the build log).  What was timed
// (kernel_timing.py flash-families, the parent, this, this, the parent in
// one call; CUDA events; NVIDIA H100 80GB HBM3, 700 W; PERF.md rows
// 8b-8c): the two launches took gemma2's [8, 16, KV 8, 1024] from 14.93 to
// 7.09 ms, recurrentgemma's band from 61.43-61.50 to 24.50-24.51 and
// deepseek's [8, 128, KV 128, 1024] from 58.39-58.59 to 36.44-36.63
// (dK/dV 21.1, dQ 14.9: behind SDPA's 32.8).  Not kept: 16 q rows a step
// at (256, 256) with 32 keys (7.77 ms against 7.10), 32 q rows with 64
// keys at (192, 128) (700 bytes of spill); the depth loop unrolled 1 and
// the product's B held two n tiles at a time (both slower, neither
// removed the spill); a compiler fence between m tiles (ptxas reorders
// past it).
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
// The wide plan also computes seven (S^T and dP^T once a dK/dV step, S and
// dP once a dQ step), on eight warps an SM.
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
  return bwd_dmax<DK, DV>() <= 64 ? REPRO_BWD_DKDV_BQ : 32;
}

template <typename T, int DK, int DV>
constexpr size_t dkdv_smem_bytes() {
  // K, V; Q and dO twice; lse and Delta twice
  constexpr int BQ = dkdv_bq<DK, DV>();
  return ((size_t)(BWD_BK + 2 * BQ) * row_ld<T, DK>()
          + (size_t)(BWD_BK + 2 * BQ) * row_ld<T, DV>()) * sizeof(T)
         + 4 * BQ * sizeof(float);
}

template <typename T, int DK, int DV>
constexpr size_t dq_smem_bytes() {
  // Q, dO; K and V twice
  return ((size_t)(BWD_BQ + 2 * BWD_DQ_BK) * row_ld<T, DK>()
          + (size_t)(BWD_BQ + 2 * BWD_DQ_BK) * row_ld<T, DV>()) * sizeof(T);
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

// acc[j] += A B_j (j < N) as gemm_rn, the product summed apart and added
// to acc (add_to).
template <typename T, int N, int NA>
__device__ __forceinline__ void add_product(float (&acc)[N][4],
                                            const float (&a)[NA][4],
                                            const T* Bs, int ld, int g,
                                            int t) {
  float part[N][4];
  zero(part);
  gemm_rn<T, N, NA>(part, a, Bs, ld, g, t);
  add_to(acc, part);
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

// dK and dV of one 64-key tile of one KV head, summed over the group's
// heads.  Warp w owns keys 16w..16w+15 of the tile.  S^T = K Q^T runs at
// DK, dP^T = V dO^T at DV, dV += P^T dO at DV and dK += dS^T Q at DK.
template <typename T, int DK, int DV>
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);   // [BK][LDK]
  T* Vs = Ks + BK * LDK;                    // [BK][LDV]
  T* Qs = Vs + BK * LDV;                    // [2][BQ][LDK]
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
    stage_vec<BQ>(dl_s + buf * BQ, delta + off, q_lo, S);
  };
  stage_rows<T, DK, BK>(Ks, k + b * st.k[0] + kvh * st.k[1], st.k[2], k_lo,
                        S);
  stage_rows<T, DV, BK>(Vs, v + b * st.v[0] + kvh * st.v[1], st.v[2], k_lo,
                        S);
  stage(0);
  cp_async_commit();

  float dk_acc[NDK][4], dv_acc[NDV][4];
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
    gemm_nt<T, DK, NQ>(s, Ks, Qb, LDK, m, g, t);     // S^T = K Q^T
    gemm_nt<T, DV, NQ>(dp, Vs, dOb, LDV, m, g, t);   // dP^T = V dO^T
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_lo + m + g + (e & 2 ? 8 : 0);
        const int c = 8 * j + 2 * t + (e & 1);     // q row in the tile
        p_and_ds(s[j][e], dp[j][e], lb[c], db[c],
                 visible(q_lo + c, kpos, S, window), cap, scale);
      }
    // dV += P^T dO, then dK += dS^T Q, each step's product summed apart
    add_product<T, NDV, NQ>(dv_acc, s, dOb, LDV, g, t);
    add_product<T, NDK, NQ>(dk_acc, dp, Qb, LDK, g, t);
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  T* dkb = dk + b * st.dk[0] + kvh * st.dk[1];
  T* dvb = dv + b * st.dv[0] + kvh * st.dv[1];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int key = k_lo + m + g + (e & 2 ? 8 : 0);
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < NDK; ++j)
      store(&dkb[key * st.dk[2] + 8 * j + 2 * t + (e & 1)],
            dk_acc[j][e] * scale);
#pragma unroll
    for (int j = 0; j < NDV; ++j)
      store(&dvb[key * st.dv[2] + 8 * j + 2 * t + (e & 1)], dv_acc[j][e]);
  }
}

// dQ of one 64-row q tile of one head, over the KV tiles the forward
// visits.  Warp w owns rows 16w..16w+15 of the tile.  S = Q K^T runs at
// DK, dP = dO V^T at DV, dQ += dS K at DK.
template <typename T, int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int KV, int S, int window, float cap, float scale,
                    BwdStrides st) {
  constexpr int BQ = BWD_BQ, BK = BWD_DQ_BK;
  constexpr int LDK = row_ld<T, DK>(), LDV = row_ld<T, DV>();
  constexpr int NK = BK / 8, NDK = DK / 8;
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
    gemm_nt<T, DK, NK>(s, Qs, Kb, LDK, m, g, t);     // S = Q K^T
    gemm_nt<T, DV, NK>(dp, dOs, Vb, LDV, m, g, t);   // dP = dO V^T
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
        p_and_ds(s[j][e], dp[j][e], lse_r[r], dl_r[r],
                 visible(q_lo + m + g + 8 * r, kpos, S, window), cap, scale);
      }
    add_product<T, NDK, NK>(acc, dp, Kb, LDK, g, t);   // dQ += dS K
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  T* dqb = dq + b * st.dq[0] + h * st.dq[1];
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
// The float32 backward at (256, 256) and (192, 128): eight warps a CTA in
// two roles of four (plan in the header above).
// ---------------------------------------------------------------------------

constexpr int WIDE_THREADS = 256;           // eight warps

// keys a dK/dV CTA: with 64, dK and dV take 128 registers a thread at
// (256, 256) and the kernel spilled
constexpr int DKDV_KEYS = 32;

// q rows a dK/dV step; may be set with -D to time another
// (kernel_timing.py flash-families)
#ifndef REPRO_BWD_WIDE_STEP
#define REPRO_BWD_WIDE_STEP 32
#endif
constexpr int DKDV_STEP = REPRO_BWD_WIDE_STEP;

// keys a dQ step: 32 where the tiles fit the shared memory ((192, 128)),
// 16 at (256, 256)
template <int DK, int DV>
__host__ __device__ constexpr int dq_step() {
  return DK + DV <= 320 ? 32 : 16;
}

// row of a staged P^T, dS^T or dS tile of a step of `step` columns
__host__ __device__ constexpr int wide_ldp(int step) { return step + 8; }

template <int DK, int DV>
__host__ __device__ constexpr bool wide_pair() {
  return bwd_dmax<DK, DV>() > 128;
}

// Padded row of a wide [rows, D] float tile: 8 more floats, so that the
// two-column fragment loads below touch 32 distinct banks a half warp.
template <int D>
__host__ __device__ constexpr int wide_ld() { return D + 8; }

// The thread's index, read afresh at each call: staging code built on it
// is not hoisted out of the step loop (its addresses, held across the
// loop, spilled the dK/dV kernels).
__device__ __forceinline__ int fresh_tid() {
  int tid;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  return tid;
}

// R rows of a [.., S, D] operand (row `lo` on) into a [R][wide_ld<D>]
// tile, zeros past S, by the CTA's 256 threads.
template <int D, int R>
__device__ __forceinline__ void stage_wide(float* dst, const float* src,
                                           long long stride, int lo,
                                           int S) {
  constexpr int CPR = D / 4, LD = wide_ld<D>();
  for (int c = fresh_tid(); c < R * CPR; c += WIDE_THREADS) {
    const int r = c / CPR, col = (c % CPR) * 4, row = lo + r;
    const bool in = row < S;
    cp_async16(dst + r * LD + col, in ? src + row * stride + col : src, in);
  }
}

// R floats of a row vector (element `lo` on), zeros past S.
template <int R>
__device__ __forceinline__ void stage_vec_wide(float* dst, const float* src,
                                               int lo, int S) {
  for (int r = fresh_tid(); r < R; r += WIDE_THREADS) {
    const bool in = lo + r < S;
    cp_async4(dst + r, in ? src + lo + r : src, in);
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The four warps of role 1 (threads 128..255) meet, apart from role 0.
__device__ __forceinline__ void role1_barrier() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// 3xTF32 fragments read along the depth two columns at a time: k slot t
// is column 2t of the eight, slot t + 4 column 2t + 1, in A and B alike
// (a product meets each pair of depths once either way).
__device__ __forceinline__ Tc<float>::A load_a_pairs(const float* s, int ld,
                                                     int m, int k, int g,
                                                     int t) {
  const float2 x = *reinterpret_cast<const float2*>(s + (m + g) * ld + k
                                                    + 2 * t);
  const float2 y = *reinterpret_cast<const float2*>(s + (m + g + 8) * ld
                                                    + k + 2 * t);
  return Tc<float>::a_of(x.x, y.x, x.y, y.y);
}
__device__ __forceinline__ Tc<float>::B load_b_pairs(const float* s, int ld,
                                                     int n, int k, int g,
                                                     int t) {
  const float2 x = *reinterpret_cast<const float2*>(s + (n + g) * ld + k
                                                    + 2 * t);
  return Tc<float>::b_of(x.x, x.y);
}
// B[kk][nn] = s[k + kk][n + nn], k in its natural order (slot t is row
// k + t, slot t + 4 row k + t + 4)
__device__ __forceinline__ Tc<float>::B load_b_rows(const float* s, int ld,
                                                    int k, int n, int g,
                                                    int t) {
  const float* p = s + (k + t) * ld + n + g;
  return Tc<float>::b_of(p[0], p[4 * ld]);
}

// Where column c of a step's P^T or dS tile is stored: within each eight,
// c and c + 4 side by side (c % 4 at 2 (c % 4), the upper four one on), so
// that an A fragment's slots t and t + 4 are one 8-byte load.
__device__ __forceinline__ int wide_col(int c) {
  return (c & ~7) + 2 * (c & 3) + ((c >> 2) & 1);
}

// A fragment of k step k from a split tile: hi (TF32 bits) and lo, rows m..
// of a [rows][LDP] pair stored as wide_col places them.
template <int LDP>
__device__ __forceinline__ Tc<float>::A load_a_split(const unsigned* hi,
                                                     const float* lo, int m,
                                                     int k, int g, int t) {
  const int r0 = (m + g) * LDP + k + 2 * t, r1 = r0 + 8 * LDP;
  const uint2 h0 = *reinterpret_cast<const uint2*>(hi + r0);
  const uint2 h1 = *reinterpret_cast<const uint2*>(hi + r1);
  const float2 l0 = *reinterpret_cast<const float2*>(lo + r0);
  const float2 l1 = *reinterpret_cast<const float2*>(lo + r1);
  Tc<float>::A f;
  f.hi[0] = h0.x;
  f.hi[1] = h1.x;
  f.hi[2] = h0.y;
  f.hi[3] = h1.y;
  f.lo[0] = __float_as_uint(l0.x);
  f.lo[1] = __float_as_uint(l1.x);
  f.lo[2] = __float_as_uint(l0.y);
  f.lo[3] = __float_as_uint(l1.y);
  return f;
}

// x split once, stored at [row][wide_col(c)] of a split tile of rows LDP.
template <int LDP>
__device__ __forceinline__ void store_split(unsigned* hi, float* lo, int row,
                                            int c, float x) {
  unsigned h, l;
  Tc<float>::split(x, h, l);
  const int i = row * LDP + wide_col(c);
  hi[i] = h;
  lo[i] = __uint_as_float(l);
}

// c[j] (j < NJ) = rows m..m+15 of As times rows 8j.. of Bs over their D
// columns (one warp's 16 x 8 NJ scores), depth pairs two at a time; the
// three 3xTF32 terms in accumulators of their own (three independent
// mma.sync chains an n tile), added at the end.
template <int D, int NJ>
__device__ __forceinline__ void wide_scores(float (&c)[NJ][4],
                                            const float* As,
                                            const float* Bs, int m, int g,
                                            int t) {
  constexpr int LD = wide_ld<D>();
  float hl[NJ][4], lh[NJ][4];
  zero(c);
  zero(hl);
  zero(lh);
#pragma unroll 2
  for (int k = 0; k < D; k += 8) {
    const Tc<float>::A a = load_a_pairs(As, LD, m, k, g, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const Tc<float>::B b = load_b_pairs(Bs, LD, 8 * j, k, g, t);
      mma_tf32(hl[j], a.hi, b.lo);
      mma_tf32(lh[j], a.lo, b.hi);
      mma_tf32(c[j], a.hi, b.hi);
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] += hl[j][e] + lh[j][e];
}

// acc[NT i + j] over m tile i of MT (16 MT rows) and n tile j of NT: += A_i
// B_j over a STEP deep product, A the split tile (hi, lo; rows of
// wide_ldp(STEP)), B_j columns c0 + 8j.. of the [STEP][LD] tile Bs.  Each
// m tile's product is summed apart and added in float32; B is held NC n
// tiles at a time (4, or 3 of 6), split once; a compiler fence between m
// tiles keeps ptxas from loading every tile's A ahead (at (256, 256) that
// spilled).
template <int NT, int LD, int STEP, int MT = 4>
__device__ __forceinline__ void wide_product(float (&acc)[MT * NT][4],
                                             const unsigned* hi,
                                             const float* lo,
                                             const float* Bs, int c0, int g,
                                             int t) {
  constexpr int KS = STEP / 8, LDP = wide_ldp(STEP);
  constexpr int NC = NT % 4 == 0 ? 4 : NT % 3 == 0 ? 3 : NT;
#pragma unroll
  for (int jc = 0; jc < NT; jc += NC) {
    Tc<float>::B b[KS][NC];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        b[ks][j] = load_b_rows(Bs, LD, 8 * ks, c0 + 8 * (jc + j), g, t);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float part[NC][4];
      zero(part);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const Tc<float>::A a = load_a_split<LDP>(hi, lo, 16 * i, 8 * ks, g,
                                                 t);
#pragma unroll
        for (int j = 0; j < NC; ++j) Tc<float>::mma(part[j], a, b[ks][j]);
      }
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i * NT + jc + j][e] += part[j][e];
      asm volatile("" ::: "memory");
    }
  }
}

template <int N, int M>
__device__ __forceinline__ float (&first_tiles(float (&a)[M][4]))[N][4] {
  static_assert(N <= M, "first_tiles");
  return *reinterpret_cast<float(*)[N][4]>(&a[0][0]);
}

// Rows row0 + 16 i .. (i < MT; none past S) and columns c0 + 8 j .. (j <
// NT) of a [rs-strided] output from wide_product's tiles, times f.
template <int NT, int MT, int M>
__device__ __forceinline__ void store_wide(float* out, long long rs,
                                           const float (&acc)[M][4],
                                           int row0, int c0, int S, float f,
                                           int g, int t) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 16 * i + g + (e & 2 ? 8 : 0);
        if (row < S)
          out[row * rs + c0 + 8 * j + 2 * t + (e & 1)] =
              acc[i * NT + j][e] * f;
      }
}

template <int DK, int DV>
constexpr size_t dkdv_wide_smem_bytes() {
  // K, V; Q and dO twice; P^T and dS^T, each hi and lo; P dcap; lse and
  // Delta twice
  constexpr int BK = DKDV_KEYS, ST = DKDV_STEP;
  return ((size_t)(BK + 2 * ST) * (wide_ld<DK>() + wide_ld<DV>())
          + 4 * BK * wide_ldp(ST) + BK * ST + 4 * ST) * sizeof(float);
}

template <int DK, int DV>
constexpr size_t dq_wide_smem_bytes() {
  // Q, dO; K and V twice; dS hi and lo; P dcap
  constexpr int ST = dq_step<DK, DV>();
  return ((size_t)(BWD_BQ + 2 * ST) * (wide_ld<DK>() + wide_ld<DV>())
          + 2 * BWD_BQ * wide_ldp(ST) + 2 * ST * 32) * sizeof(float);
}

// dK and dV of one tile of DKDV_KEYS keys of one KV head at a wide pair,
// summed over the group's heads (flash_bwd_dkdv_kernel's grid and steps,
// DKDV_STEP q rows a step).  Warp w: role w / 4; its 16 keys and 8 NJW q
// rows of the step's scores (MT = keys / 16 m tiles, the four warps of a
// role over them and the step's n tiles).  Each step: role 0 takes S^T =
// K Q^T over DK, turns it into P^T (staged split for dV, and P dcap for
// role 1); role 1 takes dP^T = V dO^T over DV and, once P is there, dS^T
// (staged split).  Then role 0 adds P^T dO into DV / 4 columns of dV a
// warp, role 1 dS^T Q into DK / 4 columns of dK, all the tile's keys.
template <int DK, int DV>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_dkdv_wide_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
                           int H, int KV, int S, int window, float cap,
                           float scale, BwdStrides st) {
  constexpr int BQ = DKDV_STEP, BK = DKDV_KEYS;
  constexpr int MT = BK / 16, NJW = BQ / 8 * MT / 4;   // a warp's n tiles
  constexpr int LDK = wide_ld<DK>(), LDV = wide_ld<DV>(), LDP = wide_ldp(BQ);
  constexpr int NTV = DV / 32, NTK = DK / 32;
  constexpr int NTM = NTV > NTK ? NTV : NTK;
  static_assert(NJW >= 1, "dK/dV step: a warp's n tiles");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [BK][LDK]
  float* Vs = Ks + BK * LDK;                        // [BK][LDV]
  float* Qs = Vs + BK * LDV;                        // [2][BQ][LDK]
  float* dOs = Qs + 2 * BQ * LDK;                   // [2][BQ][LDV]
  unsigned* Ph = reinterpret_cast<unsigned*>(dOs + 2 * BQ * LDV);
  float* Pl = reinterpret_cast<float*>(Ph + BK * LDP);        // P^T
  unsigned* Dh = reinterpret_cast<unsigned*>(Pl + BK * LDP);
  float* Dl = reinterpret_cast<float*>(Dh + BK * LDP);        // dS^T
  float* pd = Dl + BK * LDP;                 // [4][NJW * 4][32] P dcap
  float* lse_s = pd + 4 * NJW * 4 * 32;      // [2][BQ]
  float* dl_s = lse_s + 2 * BQ;              // [2][BQ]

  const int nb = gridDim.x / (((S + BK - 1) / BK) * KV);   // batch size
  const int k_lo = (blockIdx.x / (KV * nb)) * BK;
  const int kvh = blockIdx.x % KV, b = (blockIdx.x / KV) % nb;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int role = warp / 4, mt = warp % 4;
  const int m = 16 * (mt % MT), n0 = 8 * NJW * (mt / MT);  // its scores

  const int nq = (S + BQ - 1) / BQ;
  const int k_hi = min(k_lo + BK - 1, S - 1);
  const int i_lo = k_lo / BQ;
  const int i_hi = window ? min(nq - 1, (k_hi + window - 1) / BQ) : nq - 1;
  const int n_it = i_hi - i_lo + 1, steps = G * n_it;

  auto stage = [&](int step) {
    const int h = kvh * G + step / n_it, q_lo = (i_lo + step % n_it) * BQ;
    const int buf = step & 1;
    stage_wide<DK, BQ>(Qs + buf * BQ * LDK, q + b * st.q[0] + h * st.q[1],
                       st.q[2], q_lo, S);
    stage_wide<DV, BQ>(dOs + buf * BQ * LDV,
                       dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                       q_lo, S);
    const long long off = ((long long)b * H + h) * S;
    stage_vec_wide<BQ>(lse_s + buf * BQ, lse + off, q_lo, S);
    stage_vec_wide<BQ>(dl_s + buf * BQ, delta + off, q_lo, S);
  };
  stage_wide<DK, BK>(Ks, k + b * st.k[0] + kvh * st.k[1], st.k[2], k_lo, S);
  stage_wide<DV, BK>(Vs, v + b * st.v[0] + kvh * st.v[1], st.v[2], k_lo, S);
  stage(0);
  cp_async_commit();

  float acc[MT * NTM][4];    // dV (role 0) or dK (role 1): MT m x NT n tiles
  zero(acc);
  float* pdw = pd + mt * NJW * 4 * 32 + lane;  // this lane's P dcap

  for (int step = 0; step < steps; ++step) {
    cp_async_wait_all();   // this step's tiles have landed ...
    __syncthreads();       // ... for every thread; the last step is done
    if (step + 1 < steps) {
      stage(step + 1);
      cp_async_commit();
    }
    const int buf = step & 1, q_lo = (i_lo + step % n_it) * BQ;
    const float* Qb = Qs + buf * BQ * LDK;
    const float* dOb = dOs + buf * BQ * LDV;
    const float* lb = lse_s + buf * BQ;
    const float* db = dl_s + buf * BQ;

    float c[NJW][4];
    if (role == 0) {
      wide_scores<DK, NJW>(c, Ks, Qb + n0 * LDK, m, g, t);   // S^T = K Q^T
#pragma unroll
      for (int j = 0; j < NJW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = m + g + (e & 2 ? 8 : 0);        // key in the tile
          const int col = n0 + 8 * j + 2 * t + (e & 1); // q row in the step
          float x = c[j][e] * scale, dcap = 1.f;
          if (cap != 0.f) {
            const float th = tanhf(x / cap);
            x = cap * th;
            dcap = 1.f - th * th;
          }
          const float p = visible(q_lo + col, k_lo + r, S, window)
                              ? expf(x - lb[col]) : 0.f;
          store_split<LDP>(Ph, Pl, r, col, p);
          pdw[(4 * j + e) * 32] = p * dcap;
        }
    } else {
      wide_scores<DV, NJW>(c, Vs, dOb + n0 * LDV, m, g, t);  // dP^T = V dO^T
    }
    __syncthreads();       // P^T and P dcap are staged
    if (role == 0) {
      wide_product<NTV, LDV, BQ, MT>(first_tiles<MT * NTV>(acc), Ph, Pl, dOb,
                                     8 * NTV * mt, g, t);   // dV += P^T dO
    } else {
#pragma unroll
      for (int j = 0; j < NJW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * j + 2 * t + (e & 1);
          store_split<LDP>(Dh, Dl, m + g + (e & 2 ? 8 : 0), col,
                           pdw[(4 * j + e) * 32] * (c[j][e] - db[col]));
        }
      role1_barrier();     // dS^T is staged, all the tile's keys
      wide_product<NTK, LDK, BQ, MT>(first_tiles<MT * NTK>(acc), Dh, Dl, Qb,
                                     8 * NTK * mt, g, t);   // dK += dS^T Q
    }
  }

  // role 0 stores dV, role 1 dK (times the scale)
  if (role == 0)
    store_wide<NTV, MT>(dv + b * st.dv[0] + kvh * st.dv[1], st.dv[2], acc,
                        k_lo, 8 * NTV * mt, S, 1.f, g, t);
  else
    store_wide<NTK, MT>(dk + b * st.dk[0] + kvh * st.dk[1], st.dk[2], acc,
                        k_lo, 8 * NTK * mt, S, scale, g, t);
}

// dQ of one 64-row q tile of one head at a wide pair, over the KV tiles the
// forward visits, dq_step keys a step (flash_bwd_dq_kernel's grid).
// Warp w: role w / 4, q rows 16 (w % 4).. of the tile.  Each step: role 0
// takes S = Q K^T over DK and P dcap; role 1 dP = dO V^T over DV and then
// dS (staged split); then every warp adds dS K into DK / 8 columns of dQ,
// all 64 rows.
template <int DK, int DV>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_dq_wide_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq, int H, int KV, int S,
                         int window, float cap, float scale,
                         BwdStrides st) {
  constexpr int BQ = BWD_BQ, BK = dq_step<DK, DV>(), NJ = BK / 8;
  constexpr int LDK = wide_ld<DK>(), LDV = wide_ld<DV>(), LDP = wide_ldp(BK);
  constexpr int NT = DK / 64;                 // dQ n tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BQ][LDK]
  float* dOs = Qs + BQ * LDK;                       // [BQ][LDV]
  float* Ks = dOs + BQ * LDV;                       // [2][BK][LDK]
  float* Vs = Ks + 2 * BK * LDK;                    // [2][BK][LDV]
  unsigned* Dh = reinterpret_cast<unsigned*>(Vs + 2 * BK * LDV);
  float* Dl = reinterpret_cast<float*>(Dh + BQ * LDP);        // dS
  float* pd = Dl + BQ * LDP;                 // [4][NJ * 4][32] P dcap

  const int nq = (S + BQ - 1) / BQ;
  const int nb = gridDim.x / (nq * H);                       // batch size
  const int q_lo = (nq - 1 - (int)(blockIdx.x / (H * nb))) * BQ;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % nb;
  const int kvh = h / (H / KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int role = warp / 4, mt = warp % 4, m = 16 * mt;

  const float* kb = k + b * st.k[0] + kvh * st.k[1];
  const float* vb = v + b * st.v[0] + kvh * st.v[1];
  const int q_hi = min(q_lo + BQ - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;
  auto stage = [&](int jt) {
    const int buf = (jt - j_lo) & 1;
    stage_wide<DK, BK>(Ks + buf * BK * LDK, kb, st.k[2], jt * BK, S);
    stage_wide<DV, BK>(Vs + buf * BK * LDV, vb, st.v[2], jt * BK, S);
  };
  stage_wide<DK, BQ>(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q_lo, S);
  stage_wide<DV, BQ>(dOs, dout + b * st.dout[0] + h * st.dout[1],
                     st.dout[2], q_lo, S);
  stage(j_lo);
  cp_async_commit();

  // this thread's rows g and g + 8 of its warp's 16: lse (role 0) or
  // Delta (role 1)
  float row_v[2];
  const long long off = ((long long)b * H + h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + m + g + 8 * r;
    row_v[r] = row < S ? (role == 0 ? lse : delta)[off + row] : 0.f;
  }
  float acc[4 * NT][4];
  zero(acc);
  float* pdw = pd + mt * NJ * 4 * 32 + lane;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    cp_async_wait_all();
    __syncthreads();
    if (jt < j_hi) {
      stage(jt + 1);
      cp_async_commit();
    }
    const int buf = (jt - j_lo) & 1, k_lo = jt * BK;
    const float* Kb = Ks + buf * BK * LDK;
    const float* Vb = Vs + buf * BK * LDV;

    float c[NJ][4];
    if (role == 0) {
      wide_scores<DK, NJ>(c, Qs, Kb, m, g, t);          // S = Q K^T
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
          float x = c[j][e] * scale, dcap = 1.f;
          if (cap != 0.f) {
            const float th = tanhf(x / cap);
            x = cap * th;
            dcap = 1.f - th * th;
          }
          const float p = visible(q_lo + m + g + 8 * r, kpos, S, window)
                              ? expf(x - row_v[r]) : 0.f;
          pdw[(4 * j + e) * 32] = p * dcap;
        }
    } else {
      wide_scores<DV, NJ>(c, dOs, Vb, m, g, t);         // dP = dO V^T
    }
    __syncthreads();       // P dcap is staged
    if (role == 1) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store_split<LDP>(Dh, Dl, m + g + (e & 2 ? 8 : 0),
                           8 * j + 2 * t + (e & 1),
                           pdw[(4 * j + e) * 32] * (c[j][e] - row_v[e >> 1]));
    }
    __syncthreads();       // dS is staged, all 64 rows
    wide_product<NT, LDK, BK>(acc, Dh, Dl, Kb, 8 * NT * warp, g,
                              t);                        // dQ += dS K
  }

  store_wide<NT, 4>(dq + b * st.dq[0] + h * st.dq[1], st.dq[2], acc, q_lo,
                    8 * NT * warp, S, scale, g, t);
}

// The dK/dV and dQ kernels at a wide pair, after the Delta kernel.
template <int DK, int DV>
cudaError_t launch_backward_wide(const float* q, const float* k,
                                 const float* v, const float* dout,
                                 const float* lse, const float* delta,
                                 float* dq, float* dk, float* dv, int B,
                                 int H, int KV, int S, int window, float cap,
                                 float scale, const BwdStrides& st,
                                 cudaStream_t stream) {
  const size_t kv_bytes = dkdv_wide_smem_bytes<DK, DV>();
  const size_t q_bytes = dq_wide_smem_bytes<DK, DV>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wide_kernel<DK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dq_wide_kernel<DK, DV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)q_bytes);
  if (err != cudaSuccess) return err;
  const unsigned kv_ctas = (S + DKDV_KEYS - 1) / DKDV_KEYS * KV * B;
  const unsigned q_ctas = (S + BWD_BQ - 1) / BWD_BQ * H * B;
  flash_bwd_dkdv_wide_kernel<DK, DV>
      <<<kv_ctas, WIDE_THREADS, kv_bytes, stream>>>(
          q, k, v, dout, lse, delta, dk, dv, H, KV, S, window, cap, scale,
          st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<DK, DV><<<q_ctas, WIDE_THREADS, q_bytes, stream>>>(
      q, k, v, dout, lse, delta, dq, H, KV, S, window, cap, scale, st);
  return cudaGetLastError();
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
// past S, by the CTA's NT threads.
template <int D, int R, int NT = TC_THREADS>
__device__ __forceinline__ void stage_tile(bf16* dst, const bf16* src,
                                           long long stride, int lo, int S) {
  constexpr int CPR = D / 8;
  unsigned char* base = reinterpret_cast<unsigned char*>(dst);
  for (int c = threadIdx.x; c < R * CPR; c += NT) {
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

// ---------------------------------------------------------------------------
// The bfloat16 forward on wgmma (design in the header): warpgroups of 64 q
// rows sharing K and V, a head-major grid, flash_fwd_kernel's tile skip,
// mask, cap and NEG; on the wg section's instructions, staging and
// descriptors.  A namespace of its own, so that the backward's kernels
// stay those whose mangled names hold "2wg" (chip_smoke.WGMMA_BWD_SASS).
// ---------------------------------------------------------------------------

namespace wgf {

using namespace wg;

// keys a KV tile of the wgmma forward: 64, 32 where Q, K and V at 64
// would leave room for one CTA an SM
template <int DK, int DV>
__host__ __device__ constexpr int fwd_bk() { return DK + DV > 384 ? 32 : 64; }

// Warpgroups a CTA of the wgmma forward, 64 q rows each, sharing the K and
// V tiles (three: 1.43 ms at deepseek-v3's shape, two: 1.60; see the
// header); may be set with -D to time another count (kernel_timing.py
// flash-families); two at DV = 256, where three would not fit the
// registers.
#ifndef REPRO_FWD_WG_GROUPS
#define REPRO_FWD_WG_GROUPS 3
#endif

template <int DK, int DV>
__host__ __device__ constexpr int fwd_groups() {
  return DV > 128 ? 2 : REPRO_FWD_WG_GROUPS;
}

template <int DK, int DV>
constexpr size_t fwd_smem_bytes() {
  // 1 KB to align; Q; K and V twice
  return 1024 + ((size_t)fwd_groups<DK, DV>() * FWD_BQ * DK
                 + 2 * (size_t)fwd_bk<DK, DV>() * (DK + DV)) * 2;
}

constexpr float LN2 = 0.6931471805599453f;

template <int DK, int DV>
__global__ void __launch_bounds__(TC_THREADS * fwd_groups<DK, DV>())
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, int H, int KV, int S, int window,
           float cap, float scale, Strides st) {
  constexpr int NWG = fwd_groups<DK, DV>(), NTHR = TC_THREADS * NWG;
  constexpr int BQ = FWD_BQ * NWG, BK = fwd_bk<DK, DV>();
  constexpr int NK = BK / 8, ND = DV / 8, NP = DV / 64, KS = DK / 16;
  constexpr int BS = BK / 16;
  static_assert(DK % 64 == 0 && DV % 64 == 0, "wgmma forward: 64-wide");
  extern __shared__ unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(align1k(smem_raw));   // [BQ, DK]
  bf16* Ks = Qs + BQ * DK;                                 // [2][BK, DK]
  bf16* Vs = Ks + 2 * BK * DK;                             // [2][BK, DV]

  // one linear grid, head-major: a head's q tiles (the last, longest,
  // first) run side by side and share its K and V tiles in L2
  const int nq = (S + BQ - 1) / BQ;
  const int q_lo = (nq - 1 - (int)(blockIdx.x % nq)) * BQ;
  const int h = (blockIdx.x / nq) % H, b = blockIdx.x / (nq * H);
  const int kvh = h / (H / KV);
  const int wgi = threadIdx.x / TC_THREADS;     // this thread's warpgroup
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;
  const int wq_lo = q_lo + FWD_BQ * wgi;        // its first q row
  const int wq_hi = min(wq_lo + FWD_BQ - 1, S - 1);
  // the warpgroup's rows of Q: panel 0 of the [BQ, DK] tile, row 64 wgi
  const bf16* Qw = Qs + FWD_BQ * wgi * 64;

  const bf16* kb = k + b * st.k[0] + kvh * st.k[1];
  const bf16* vb = v + b * st.v[0] + kvh * st.v[1];
  const int q_hi = min(q_lo + BQ - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;
  auto stage = [&](int jt) {
    const int buf = (jt - j_lo) & 1;
    stage_tile<DK, BK, NTHR>(Ks + buf * BK * DK, kb, st.k[2], jt * BK, S);
    stage_tile<DV, BK, NTHR>(Vs + buf * BK * DV, vb, st.v[2], jt * BK, S);
  };
  stage_tile<DK, BQ, NTHR>(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q_lo,
                           S);
  stage(j_lo);
  cp_async_commit();

  // this thread's rows g and g + 8 of its warp's 16: the running max (of
  // the scores times log2 e) and sum
  float m_r[2] = {NEG, NEG}, l_r[2] = {0.f, 0.f};
  float acc[NP][8][4];       // O by 64-wide panels
#pragma unroll
  for (int p = 0; p < NP; ++p) zero(acc[p]);
  const float scale_l2 = scale * LOG2E;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    if (jt < j_hi) stage(jt + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles (and Q) have landed
    fence_async_smem();
    __syncthreads();
    const int buf = (jt - j_lo) & 1, k_lo = jt * BK;
    const bf16* Kb = Ks + buf * BK * DK;
    const bf16* Vb = Vs + buf * BK * DV;
    // a tile no row of this warpgroup sees is skipped by it whole
    if (wq_lo < S && k_lo <= wq_hi
        && (!window || k_lo + BK - 1 > wq_lo - window)) {
      // Every product lands in a fresh accumulator (zeroed, or discarded
      // by its first k step) and is added to O in float32: O is never a
      // wgmma accumulator, so no other instruction defines one between a
      // product's issue and its wait (which makes ptxas serialize the
      // products, C7515).
      float s[NK][4];                                // S = Q K^T
      zero(s);
      hold(s);
      fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_ss<BK, 0>(s, desc_k<DK, BQ>(Qw, ks), desc_k<DK, BK>(Kb, ks),
                      ks);
      commit();
      wait_all();
      hold(s);

      // a tile every row of the warpgroup sees whole skips the mask
      const bool seen = k_lo + BK - 1 <= wq_lo
                        && (!window || wq_lo + FWD_BQ - 1 - k_lo < window);
      float corr[2];
      with_flags(seen, cap != 0.f, [&](auto all_seen, auto capped) {
        constexpr bool kPlain = decltype(all_seen)::value
                                && !decltype(capped)::value;
        float mx[2] = {NEG, NEG};
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float y;         // the score times log2 e (kPlain: the raw one)
            if constexpr (kPlain)
              y = s[j][e];
            else if constexpr (decltype(capped)::value)
              y = cap * tanhf(s[j][e] * scale / cap) * LOG2E;
            else
              y = s[j][e] * scale_l2;
            if constexpr (!decltype(all_seen)::value) {
              const int qpos = wq_lo + m + g + 8 * r;
              const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
              bool keep = qpos >= kpos;
              if (window) keep = keep && (qpos - kpos) < window;
              y = keep ? y : NEG;
            }
            s[j][e] = y;
            mx[r] = fmaxf(mx[r], y);
          }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          if constexpr (kPlain) mx[r] *= scale_l2;   // scale_l2 > 0
          const float m_new = fmaxf(m_r[r], mx[r]);
          asm("ex2.approx.ftz.f32 %0, %1;"
              : "=f"(corr[r]) : "f"(m_r[r] - m_new));
          m_r[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // kPlain: 2^(s scale log2 e - m) as one FFMA
            const float x = kPlain ? fmaf(s[j][e], scale_l2, -m_r[e >> 1])
                                   : s[j][e] - m_r[e >> 1];
            float p;
            asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(p) : "f"(x));
            s[j][e] = p;
            sum[e >> 1] += p;
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
          sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
          l_r[r] = l_r[r] * corr[r] + sum[r];
        }
      });

      // O = O corr + P V, a 64-wide panel at a time: P rounded to bf16 in
      // registers, V read MN-major
      unsigned pa[BS][4];
      to_a(pa, s);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        float part[8][4];
        zero(part);
        hold(part);
        fence();
#pragma unroll
        for (int i = 0; i < BS; ++i)
          mma_rs<64, 1>(part, pa[i], desc_mn<DV, BK>(Vb, i, p), i);
        commit();
        wait_all();
        hold(part);
        hold(pa);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[p][j][e] = fmaf(acc[p][j][e], corr[e >> 1], part[j][e]);
      }
    }
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  bf16* ob = o + b * st.o[0] + h * st.o[1];
  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l_r[r] == 0.f ? 1.f : l_r[r];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int row = wq_lo + m + g + (e & 2 ? 8 : 0);
      if (row < S)
        *reinterpret_cast<__nv_bfloat162*>(
            &ob[row * st.o[2] + 8 * j + 2 * t]) =
            __floats2bfloat162_rn(acc[j / 8][j % 8][e] / l[e >> 1],
                                  acc[j / 8][j % 8][e + 1] / l[e >> 1]);
    }
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wq_lo + m + g + 8 * r;
      if (row < S)
        lse[((long long)b * H + h) * S + row] = m_r[r] * LN2 + logf(l[r]);
    }
  }
}

template <int DK, int DV>
cudaError_t launch_forward(const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int H, int KV, int S,
                           int window, float cap, const Strides& st,
                           cudaStream_t stream) {
  const size_t bytes = fwd_smem_bytes<DK, DV>();
  auto kernel = fwd_kernel<DK, DV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)DK));
  constexpr int NTHR = TC_THREADS * fwd_groups<DK, DV>();
  constexpr int BQ = FWD_BQ * fwd_groups<DK, DV>();
  const unsigned ctas = (S + BQ - 1) / BQ * H * B;
  kernel<<<ctas, NTHR, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KV, S,
      window, cap, scale, st);
  return cudaGetLastError();
}

// The pairs the wgmma forward is built for (ops.WGMMA_FWD_HEAD_DIMS):
// MLA's (192, 128), which ops.forward_plan routes here, and the square
// ones it is timed at beside the mma.sync kernel.
cudaError_t dispatch_forward(int DK, int DV, const void* q, const void* k,
                             const void* v, void* o, float* lse, int B,
                             int H, int KV, int S, int window, float cap,
                             const Strides& st, cudaStream_t stream) {
#define REPRO_WG_FWD_CASE(dk, dv)                                          \
  if (DK == dk && DV == dv)                                                \
    return launch_forward<dk, dv>(q, k, v, o, lse, B, H, KV, S, window, cap, \
                                  st, stream);
  REPRO_WG_FWD_CASE(64, 64)
  REPRO_WG_FWD_CASE(128, 128)
  REPRO_WG_FWD_CASE(192, 128)
  REPRO_WG_FWD_CASE(256, 256)
#undef REPRO_WG_FWD_CASE
  return cudaErrorInvalidValue;
}

}  // namespace wgf

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
  } else if constexpr (wide_pair<DK, DV>()) {   // eight warps a CTA
    return launch_backward_wide<DK, DV>(q, k, v, dout, lse, delta, dq, dk,
                                        dv, B, H, KV, S, window, cap, scale,
                                        st, stream);
  } else {     // float32: 3xTF32 on mma.sync, four warps a CTA
    const size_t kv_bytes = dkdv_smem_bytes<T, DK, DV>();
    auto dkdv = flash_bwd_dkdv_kernel<T, DK, DV>;
    err = cudaFuncSetAttribute(
        dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kv_bytes);
    if (err != cudaSuccess) return err;
    const unsigned kv_ctas = (S + BWD_BK - 1) / BWD_BK * KV * B;
    dkdv<<<kv_ctas, TC_THREADS, kv_bytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, H, KV, S, window, cap, scale, st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t q_bytes = dq_smem_bytes<T, DK, DV>();
    auto dqk = flash_bwd_dq_kernel<T, DK, DV>;
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)q_bytes);
    if (err != cudaSuccess) return err;
    const unsigned q_ctas = (S + BWD_BQ - 1) / BWD_BQ * H * B;
    dqk<<<q_ctas, TC_THREADS, q_bytes, stream>>>(
        q, k, v, dout, lse, delta, dq, H, KV, S, window, cap, scale, st);
    return cudaGetLastError();
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
// addressed through `strides` (12 int64: batch, head and sequence strides
// of q, k, v, o, in elements; the head dimension is contiguous).  dtype 0 =
// float32, 1 = bfloat16.  kernel 0: flash_fwd_kernel (mma.sync), (D, Dv)
// one of the pairs `dispatch` lists; kernel 1: the bf16 wgmma forward
// (bfloat16 only, the pairs `wgf::dispatch_forward` lists; o's strides even
// and o 4-byte aligned: it stores bf16 pairs).  lse: null, or float32
// [B, H, S] (contiguous) for each row's log-sum-exp.  Returns the launch's
// cudaGetLastError() (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, void* lse, int dtype, int B, int H, int KV,
                          int S, int D, int Dv, int window, float cap,
                          int kernel, const long long* strides,
                          void* stream) {
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (kernel == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (((st.o[0] | st.o[1] | st.o[2]) & 1)
        || (reinterpret_cast<unsigned long long>(o) & 3))
      return (int)cudaErrorMisalignedAddress;
    return (int)wgf::dispatch_forward(D, Dv, q, k, v, o, l, B, H, KV, S,
                                      window, cap, st, s);
  }
  if (kernel != 0) return (int)cudaErrorInvalidValue;
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
