// Tangents of causal GQA flash attention for Hopper (sm_90a), float32 as
// 3xTF32 on the tensor cores (mma.sync): the forward's tangent and the
// backward's tangent, which carry a Hessian-vector product (forward over
// reverse) through attention.
//
// Replaces no Pallas kernel of its own: the reference takes these tangents
// by `jax.jvp` of `jax.grad` through the pure-JAX `chunked_attention`
// (src/repro/models/attention.py:38), which XLA differentiates twice; the
// port's attention is the kernel of flash_attention.cu (the Pallas `_kernel`
// of src/repro/kernels/flash_attention/flash_attention.py:28), so its
// tangents are kernels too.  Plain versions: ref.py's `attention_jvp_ref`
// and `attention_backward_jvp_ref`.
//
// Notation (one batch row b, query head h, KV head h / (H / KV)):
//   S0 = scale Q K^T, S = cap tanh(S0 / cap) (or S0), masked as the forward
//   masks (key j <= query i, and i - j < window where window > 0);
//   P = exp(S - lse) with the forward's log-sum-exp; O = P V;
//   c' = 1 - tanh^2(S0 / cap) (or 1).
// Forward tangent (tQ, tK, tV -> tO, t_lse):
//   tS = c' scale (tQ K^T + Q tK^T), t_lse = sum_j P tS,
//   tP = P (tS - t_lse), tO = tP V + P tV
//      = sum_j (P tS) V + P tV - t_lse O,
// so one pass over the live KV tiles with the forward's lse (no online
// rescaling) sums A = (P tS) V + P tV and t_lse, and writes tO = A - t_lse O
// with O the forward's own output (an input here).
// Backward tangent (D = rowsum(dO O), dS = P (dO V^T - D), dS0 = c' dS;
// dQ = scale dS0 K, dK = scale dS0^T Q, dV = P^T dO):
//   tdP = tdO V^T + dO tV^T, tD = rowsum(tdO O + dO tO),
//   tdS = tP (dP - D) + P (tdP - tD),
//   tdS0 = c' tdS + dS c'' tS0, c'' = -2 tanh(S0 / cap) c' / cap,
//   tdQ = scale (tdS0 K + dS0 tK), tdK = scale (tdS0^T Q + dS0^T tQ),
//   tdV = tP^T dO + P^T tdO,
// split as the backward is split: a row pass for D and tD (one warp a row),
// a dK/dV kernel over key tiles and a dQ kernel over query tiles.  No float
// atomics: two runs give the same bits.
//
// Design: the float32 flash kernels' (flash_attention.cu), on the shared
// machinery of tensor_core.cuh.  Every CTA is four warps and owns a 64-row
// tile, 16 rows a warp; the other side is streamed in steps, its tiles
// double-buffered with cp.async, shared rows padded by 16 bytes.  Each
// product is 3xTF32 on mma.sync m16n8k8, every operand split into hi and lo
// as its fragment is loaded; a score-like tile and its tangent come from one
// pass over D (gemm_nt_tangent: each fragment feeds two products), and the
// P-like factors computed in the accumulators are the A operands of the
// next products as they lie (a_from_acc), with the streamed or fixed [rows,
// D] tiles read across rows (load_b_kn).  Each step's products are summed
// apart and added to the running sums in float32 (add_to).
//   * Forward tangent: one CTA a (64-row q tile, head, batch), one linear
//     grid with the q tile slowest (the tiles with the most KV tiles start
//     first), over the KV tiles the forward visits; Q and tQ staged once, K,
//     tK, V, tV streamed.  Per step S0 and tS0 ([tQ | Q] [K | tK]^T), then
//     P and P tS in place, t_lse's share in registers (summed over the quad
//     at the end), A += (P tS) V + P tV.  tO = A - t_lse O takes the
//     forward's O, not P V (two products fewer: the bound's 10 D a pair).
//   * dK/dV: one CTA a (64-key tile, KV head, batch), key tile slowest,
//     over the group's H / KV query heads and the q tiles that see its keys
//     (the GQA sum stays in registers); K, tK, V, tV staged once; Q, tQ,
//     dO, tdO, lse, t_lse, D and tD streamed.  Per step, transposed: S0^T,
//     tS0^T, dP^T = V dO^T and tdP^T = tV dO^T + V tdO^T, turned in place
//     into P^T, tP^T, dS0^T and tdS0^T (pair_factors), the A operands of
//     tdV += tP^T dO + P^T tdO and tdK += tdS0^T Q + dS0^T tQ.
//   * dQ: one CTA a (64-row q tile, head, batch), as the forward tangent's
//     grid; Q, tQ, dO, tdO staged once, K, tK, V, tV streamed; S0, tS0, dP,
//     tdP recomputed on the tensor cores, then tdQ += tdS0 K + dS0 tK.
// A warp whose 16 rows see the whole step skips the mask.
// Steps: the streamed side's rows a step, at D <= 64, may be set with -D
// (REPRO_JVP_FWD_BK, REPRO_JVP_DKDV_BQ, REPRO_JVP_DQ_BK); 16 each, the
// fastest at the training shape below, and 16 at D = 128, where larger
// steps do not fit 227 KB or spill.  Whole launches by CUDA events, each
// kernel by a profile, all in one call (kernel_timing.py flash-jvp -D ...;
// NVIDIA H100 80GB HBM3, 700 W; registers a thread, shared memory, CTAs
// an SM):
//   forward tangent, keys a step: 16: 1.845-1.848 ms (127, 70 KB, three);
//     32: 2.175 ms (182, 104 KB, two); 64: 2.845 ms (234, 174 KB, one);
//   dK/dV, q rows a step: 16: 4.56 ms (168 and 8 bytes of spills, 105 KB,
//     two); 32: 4.90 ms (255, 140 KB, one); 64: 9.78 ms (255 and 156
//     bytes of spills, 209 KB, one);
//   dQ, keys a step: 16: 3.62 ms (168 and 8 bytes of spills, 104 KB, two);
//     32: 3.83 ms (206, 139 KB, one); 64: 7.57 ms (254 and 72 bytes of
//     spills, 209 KB, one);
//   so the backward tangent 8.22-8.28 ms at 16, 8.72 at 32, 17.33 at 64
//   (the row pass 0.09 ms).
// At D = 128 the dK/dV kernel spills 48 bytes, the forward tangent 8.
//
// What bounds these kernels on this card: operations.  At the training
// shape (B=8, H=32, KV=4, S=1024, D=64) the forward tangent needs 10 D
// flops a live (query, key) pair (S0, tS0's two products, tO's two), the
// backward tangent 24 D (S0, tS0, dP, tdP and two products for each of
// tdQ, tdK, tdV), over B H S (S + 1) / 2 pairs: 8.6e10 and 2.1e11 flops,
// 0.52 and 1.25 ms as 3xTF32 on the tensor cores (three TF32 operations a
// float32 one at 495 TFLOP/s), against 0.30 and 0.52 GB of inputs and
// outputs.  The forward tangent does just those products; the backward
// tangent 36 D (the dQ kernel recomputes S0, tS0, dP and tdP: its eight
// products against the two it needs).  At 1.85 and 8.25 ms they are 3.5x
// and 6.6x those bounds, as the float32 flash kernels are (3.75x and
// 5.8x): the instruction issue bounds them, each operand element costing
// three integer and float operations to split and a shared load of its own
// beside its share of three mma.sync, with two or three CTAs an SM to hide
// the latency.  The errors against the plain versions: up to 4.3e-6 of max
// |t| (forward, with O in place of P V) and 4.0e-6 (backward) at the shapes
// of chip_smoke.JVP_SHAPES, 2.3e-6 and 3.2e-6 at the training shape (the
// CUDA-core version they replace: 7.9e-7 and 4.5e-6 there).
#include <cuda_runtime.h>
#include <math.h>

#include "tensor_core.cuh"

using namespace repro_tc;

namespace {

constexpr int BT = 64;            // rows a CTA owns: 16 a warp
constexpr int ROW_THREADS = 256;  // the D / tD row pass: eight rows a block

#ifndef REPRO_JVP_FWD_BK
#define REPRO_JVP_FWD_BK 16
#endif
#ifndef REPRO_JVP_DKDV_BQ
#define REPRO_JVP_DKDV_BQ 16
#endif
#ifndef REPRO_JVP_DQ_BK
#define REPRO_JVP_DQ_BK 16
#endif

// keys a step of the forward tangent
template <int D>
__host__ __device__ constexpr int fwd_bk() {
  return D <= 64 ? REPRO_JVP_FWD_BK : 16;
}
// query rows a step of the dK/dV kernel
template <int D>
__host__ __device__ constexpr int dkdv_bq() {
  return D <= 64 ? REPRO_JVP_DKDV_BQ : 16;
}
// keys a step of the dQ kernel
template <int D>
__host__ __device__ constexpr int dq_bk() {
  return D <= 64 ? REPRO_JVP_DQ_BK : 16;
}

struct Str {                 // batch, head, sequence strides (elements)
  long long b, h, s;
};

using O = Tc<float>;

// acc[j] += A B_j^T and tacc[j] += tA B_j^T + A tB_j^T (j < NT): A, tA the
// 16 rows m.. of As, tAs; B_j, tB_j the rows 8j.. of Bs, tBs; KD columns.
// A score tile and its tangent in one pass: each A and B fragment, split
// once, feeds two products.
template <int KD, int NT>
__device__ __forceinline__ void gemm_nt_tangent(
    float (&acc)[NT][4], float (&tacc)[NT][4], const float* As,
    const float* tAs, const float* Bs, const float* tBs, int ld, int m,
    int g, int t) {
#pragma unroll
  for (int k = 0; k < KD; k += O::KS) {
    const O::A a = O::load_a(As, ld, m, k, g, t);
    const O::A ta = O::load_a(tAs, ld, m, k, g, t);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const O::B bf = O::load_b_nk(Bs, ld, 8 * j, k, g, t);
      O::mma(acc[j], a, bf);
      O::mma(tacc[j], ta, bf);
      O::mma(tacc[j], a, O::load_b_nk(tBs, ld, 8 * j, k, g, t));
    }
  }
}

// acc += A1 B1 + A2 B2, gemm_rn's operands: the step's products summed
// apart and added to acc in float32 (add_to).
template <int NT, int NA>
__device__ __forceinline__ void add_rn2(float (&acc)[NT][4],
                                        const float (&a1)[NA][4],
                                        const float* B1s,
                                        const float (&a2)[NA][4],
                                        const float* B2s, int ld, int g,
                                        int t) {
  float part[NT][4];
  zero(part);
  gemm_rn<float, NT, NA>(part, a1, B1s, ld, g, t);
  gemm_rn<float, NT, NA>(part, a2, B2s, ld, g, t);
  add_to(acc, part);
}

// ---------------------------------------------------------------------------
// Forward tangent.
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float *q, *k, *v, *o, *lse, *tq, *tk, *tv;
  float *tout, *tlse;
  Str sq, sk, sv, so, stq, stk, stv, sto;
  int H, KV, S, window;
  float cap, scale;
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  // Q, tQ; K, tK, V, tV twice
  return (size_t)(2 * BT + 8 * fwd_bk<D>()) * row_ld<float, D>()
         * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS) fwd_tangent(FwdArgs a) {
  constexpr int BK = fwd_bk<D>(), LD = row_ld<float, D>();
  constexpr int NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BT][LD]
  float* tQs = Qs + BT * LD;                        // [BT][LD]
  float* Ks = tQs + BT * LD;                        // [2][BK][LD]
  float* tKs = Ks + 2 * BK * LD;                    // [2][BK][LD]
  float* Vs = tKs + 2 * BK * LD;                    // [2][BK][LD]
  float* tVs = Vs + 2 * BK * LD;                    // [2][BK][LD]

  const int S = a.S, H = a.H, window = a.window;
  const int nq = (S + BT - 1) / BT;
  const int nb = gridDim.x / (nq * H);                       // batch size
  const int q_lo = (nq - 1 - (int)(blockIdx.x / (H * nb))) * BT;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % nb;
  const int kvh = h / (H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;

  const float* kb = a.k + b * a.sk.b + kvh * a.sk.h;
  const float* tkb = a.tk + b * a.stk.b + kvh * a.stk.h;
  const float* vb = a.v + b * a.sv.b + kvh * a.sv.h;
  const float* tvb = a.tv + b * a.stv.b + kvh * a.stv.h;
  const int q_hi = min(q_lo + BT - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;
  auto stage = [&](int jt) {
    const int off = ((jt - j_lo) & 1) * BK * LD;
    stage_rows<float, D, BK>(Ks + off, kb, a.sk.s, jt * BK, S);
    stage_rows<float, D, BK>(tKs + off, tkb, a.stk.s, jt * BK, S);
    stage_rows<float, D, BK>(Vs + off, vb, a.sv.s, jt * BK, S);
    stage_rows<float, D, BK>(tVs + off, tvb, a.stv.s, jt * BK, S);
  };
  stage_rows<float, D, BT>(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q_lo,
                           S);
  stage_rows<float, D, BT>(tQs, a.tq + b * a.stq.b + h * a.stq.h, a.stq.s,
                           q_lo, S);
  stage(j_lo);
  cp_async_commit();

  // this thread's rows g and g + 8 of the warp's 16: lse, t_lse's share
  const long long row_off = ((long long)b * H + h) * S;
  float lse_r[2], tl[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + m + g + 8 * r;
    lse_r[r] = row < S ? a.lse[row_off + row] : 0.f;
  }
  float acc[ND][4];
  zero(acc);

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    if (jt < j_hi) stage(jt + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles (and Q, tQ) have landed
    __syncthreads();
    const int off = ((jt - j_lo) & 1) * BK * LD, k_lo = jt * BK;

    float s[NK][4], ts[NK][4];   // S0 = Q K^T, tS0 = tQ K^T + Q tK^T
    zero(s);
    zero(ts);
    gemm_nt_tangent<D, NK>(s, ts, Qs, tQs, Ks + off, tKs + off, LD, m, g,
                           t);
    const bool seen = k_lo + BK - 1 <= q_lo + m
                      && (!window || q_lo + m + 15 - k_lo < window);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float x = s[j][e] * a.scale, c1 = 1.f;
        if (a.cap != 0.f) {
          const float th = tanhf(x / a.cap);
          x = a.cap * th;
          c1 = 1.f - th * th;
        }
        const bool keep =
            seen || visible(q_lo + m + g + 8 * r,
                            k_lo + 8 * j + 2 * t + (e & 1), S, window);
        const float p = keep ? expf(x - lse_r[r]) : 0.f;
        s[j][e] = p;                                   // P
        ts[j][e] = p * (c1 * (ts[j][e] * a.scale));    // P tS
        tl[r] += ts[j][e];
      }
    // A += (P tS) V + P tV
    add_rn2<ND, NK>(acc, ts, Vs + off, s, tVs + off, LD, g, t);
    __syncthreads();   // every warp is done with this buffer: it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 1);
    tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 2);
  }
  const float* ob = a.o + b * a.so.b + h * a.so.h;
  float* tob = a.tout + b * a.sto.b + h * a.sto.h;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q_lo + m + g + (e & 2 ? 8 : 0);
      const int c = 8 * j + 2 * t + (e & 1);
      if (row < S)
        tob[row * a.sto.s + c] = acc[j][e] - tl[e >> 1] * ob[row * a.so.s + c];
    }
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q_lo + m + g + 8 * r;
      if (row < S) a.tlse[row_off + row] = tl[r];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward tangent.
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float *q, *k, *v, *o, *dout, *lse, *tq, *tk, *tv, *to, *tdout,
      *tlse;
  float *delta, *tdelta, *tdq, *tdk, *tdv;
  Str sq, sk, sv, so, sdo, stq, stk, stv, sto, stdo, stdq, stdk, stdv;
  int B, H, KV, S, window;
  float cap, scale;
};

__device__ __forceinline__ long long at(const Str& t, int b, int h, int i) {
  return b * t.b + h * t.h + (long long)i * t.s;
}

// D = rowsum(dO O) and tD = rowsum(tdO O + dO tO): one warp a row.
template <int D>
__global__ void __launch_bounds__(ROW_THREADS) row_pass(BwdArgs a) {
  const long long row =
      (long long)blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (long long)a.B * a.H * a.S) return;
  const int i = (int)(row % a.S);
  const int h = (int)((row / a.S) % a.H);
  const int b = (int)(row / ((long long)a.S * a.H));
  const long long o = at(a.so, b, h, i), to = at(a.sto, b, h, i);
  const long long d_ = at(a.sdo, b, h, i), td = at(a.stdo, b, h, i);
  float s = 0.f, ts = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) {
    const float od = a.o[o + d], dod = a.dout[d_ + d];
    s = fmaf(dod, od, s);
    ts = fmaf(a.tdout[td + d], od, fmaf(dod, a.to[to + d], ts));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    ts += __shfl_xor_sync(0xffffffffu, ts, off);
  }
  if (lane == 0) {
    a.delta[row] = s;
    a.tdelta[row] = ts;
  }
}

// One pair's factors from its raw S0 and tS0 (before the scale), dP and
// tdP, and its query row's lse, t_lse, D and tD: s becomes P, ts tP, dp
// dS0 and tdp tdS0, all 0 where the pair is masked.
__device__ __forceinline__ void pair_factors(float& s, float& ts, float& dp,
                                             float& tdp, float lse,
                                             float tlse, float dl, float tdl,
                                             bool keep, float cap,
                                             float scale) {
  float x = s * scale, c1 = 1.f, c2 = 0.f;
  const float ts0 = ts * scale;
  if (cap != 0.f) {
    const float th = tanhf(x / cap);
    x = cap * th;
    c1 = 1.f - th * th;
    c2 = -2.f * th * c1 / cap;
  }
  const float p = keep ? expf(x - lse) : 0.f;
  const float tp = p * (c1 * ts0 - tlse);
  const float dpd = dp - dl;
  const float ds = p * dpd;
  const float tds = tp * dpd + p * (tdp - tdl);
  s = p;
  ts = tp;
  dp = c1 * ds;
  tdp = c1 * tds + ds * c2 * ts0;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, tK, V, tV; Q, tQ, dO, tdO twice; lse, t_lse, D, tD twice
  return (size_t)(4 * BT + 8 * dkdv_bq<D>()) * row_ld<float, D>()
         * sizeof(float) + 8 * dkdv_bq<D>() * sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, tQ, dO, tdO; K, tK, V, tV twice
  return (size_t)(4 * BT + 8 * dq_bk<D>()) * row_ld<float, D>()
         * sizeof(float);
}

// tdK and tdV of one 64-key tile of one KV head, summed over the group's
// heads.  Warp w owns keys 16w..16w+15 of the tile.
template <int D>
__global__ void __launch_bounds__(TC_THREADS) bwd_tangent_dkdv(BwdArgs a) {
  constexpr int BQ = dkdv_bq<D>(), LD = row_ld<float, D>();
  constexpr int NQ = BQ / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [BT][LD]
  float* tKs = Ks + BT * LD;                        // [BT][LD]
  float* Vs = tKs + BT * LD;                        // [BT][LD]
  float* tVs = Vs + BT * LD;                        // [BT][LD]
  float* Qs = tVs + BT * LD;                        // [2][BQ][LD]
  float* tQs = Qs + 2 * BQ * LD;                    // [2][BQ][LD]
  float* dOs = tQs + 2 * BQ * LD;                   // [2][BQ][LD]
  float* tdOs = dOs + 2 * BQ * LD;                  // [2][BQ][LD]
  float* rows_s = tdOs + 2 * BQ * LD;   // [2][lse, t_lse, D, tD][BQ]

  const int S = a.S, H = a.H, KV = a.KV, window = a.window;
  // one linear grid, key tile slowest: the tiles that the most q tiles
  // see (tile 0 first) start first, for every head and batch
  const int nb = gridDim.x / (((S + BT - 1) / BT) * KV);   // batch size
  const int k_lo = (blockIdx.x / (KV * nb)) * BT;
  const int kvh = blockIdx.x % KV, b = (blockIdx.x / KV) % nb;
  const int G = H / KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;

  // q tiles that see a key of this tile: from the one holding row k_lo to
  // the one holding the last row the window lets see the tile's last key;
  // steps run over (head of the group, q tile)
  const int nq = (S + BQ - 1) / BQ;
  const int k_hi = min(k_lo + BT - 1, S - 1);
  const int i_lo = k_lo / BQ;
  const int i_hi = window ? min(nq - 1, (k_hi + window - 1) / BQ) : nq - 1;
  const int n_it = i_hi - i_lo + 1, steps = G * n_it;

  auto stage = [&](int step) {
    const int h = kvh * G + step / n_it, q_lo = (i_lo + step % n_it) * BQ;
    const int off = (step & 1) * BQ * LD;
    stage_rows<float, D, BQ>(Qs + off, a.q + b * a.sq.b + h * a.sq.h,
                             a.sq.s, q_lo, S);
    stage_rows<float, D, BQ>(tQs + off, a.tq + b * a.stq.b + h * a.stq.h,
                             a.stq.s, q_lo, S);
    stage_rows<float, D, BQ>(dOs + off, a.dout + b * a.sdo.b + h * a.sdo.h,
                             a.sdo.s, q_lo, S);
    stage_rows<float, D, BQ>(tdOs + off,
                             a.tdout + b * a.stdo.b + h * a.stdo.h, a.stdo.s,
                             q_lo, S);
    const long long row_off = ((long long)b * H + h) * S;
    float* rb = rows_s + (step & 1) * 4 * BQ;
    stage_vec<BQ>(rb, a.lse + row_off, q_lo, S);
    stage_vec<BQ>(rb + BQ, a.tlse + row_off, q_lo, S);
    stage_vec<BQ>(rb + 2 * BQ, a.delta + row_off, q_lo, S);
    stage_vec<BQ>(rb + 3 * BQ, a.tdelta + row_off, q_lo, S);
  };
  stage_rows<float, D, BT>(Ks, a.k + b * a.sk.b + kvh * a.sk.h, a.sk.s,
                           k_lo, S);
  stage_rows<float, D, BT>(tKs, a.tk + b * a.stk.b + kvh * a.stk.h, a.stk.s,
                           k_lo, S);
  stage_rows<float, D, BT>(Vs, a.v + b * a.sv.b + kvh * a.sv.h, a.sv.s,
                           k_lo, S);
  stage_rows<float, D, BT>(tVs, a.tv + b * a.stv.b + kvh * a.stv.h, a.stv.s,
                           k_lo, S);
  stage(0);
  cp_async_commit();

  float tdk_acc[ND][4], tdv_acc[ND][4];
  zero(tdk_acc);
  zero(tdv_acc);

  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) stage(step + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles have landed
    __syncthreads();
    const int off = (step & 1) * BQ * LD;
    const int q_lo = (i_lo + step % n_it) * BQ;
    const float* Qb = Qs + off;
    const float* tQb = tQs + off;
    const float* dOb = dOs + off;
    const float* tdOb = tdOs + off;
    const float* rb = rows_s + (step & 1) * 4 * BQ;

    // transposed: S0^T = K Q^T, tS0^T = tK Q^T + K tQ^T, dP^T = V dO^T,
    // tdP^T = tV dO^T + V tdO^T
    float s[NQ][4], ts[NQ][4], dp[NQ][4], tdp[NQ][4];
    zero(s);
    zero(ts);
    zero(dp);
    zero(tdp);
    gemm_nt_tangent<D, NQ>(s, ts, Ks, tKs, Qb, tQb, LD, m, g, t);
    gemm_nt_tangent<D, NQ>(dp, tdp, Vs, tVs, dOb, tdOb, LD, m, g, t);
    const bool seen = q_lo >= k_lo + m + 15 && q_lo + BQ - 1 < S
                      && (!window || q_lo + BQ - 1 - (k_lo + m) < window);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_lo + m + g + (e & 2 ? 8 : 0);
        const int c = 8 * j + 2 * t + (e & 1);     // q row in the step
        pair_factors(s[j][e], ts[j][e], dp[j][e], tdp[j][e], rb[c],
                     rb[BQ + c], rb[2 * BQ + c], rb[3 * BQ + c],
                     seen || visible(q_lo + c, kpos, S, window), a.cap,
                     a.scale);
      }
    // tdV += tP^T dO + P^T tdO, tdK += tdS0^T Q + dS0^T tQ
    add_rn2<ND, NQ>(tdv_acc, ts, dOb, s, tdOb, LD, g, t);
    add_rn2<ND, NQ>(tdk_acc, tdp, Qb, dp, tQb, LD, g, t);
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  float* tdkb = a.tdk + b * a.stdk.b + kvh * a.stdk.h;
  float* tdvb = a.tdv + b * a.stdv.b + kvh * a.stdv.h;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k_lo + m + g + (e & 2 ? 8 : 0);
      const int c = 8 * j + 2 * t + (e & 1);
      if (key < S) {
        tdkb[key * a.stdk.s + c] = a.scale * tdk_acc[j][e];
        tdvb[key * a.stdv.s + c] = tdv_acc[j][e];
      }
    }
}

// tdQ of one 64-row q tile of one head, over the KV tiles the forward
// visits.  Warp w owns rows 16w..16w+15 of the tile.
template <int D>
__global__ void __launch_bounds__(TC_THREADS) bwd_tangent_dq(BwdArgs a) {
  constexpr int BK = dq_bk<D>(), LD = row_ld<float, D>();
  constexpr int NK = BK / 8, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [BT][LD]
  float* tQs = Qs + BT * LD;                        // [BT][LD]
  float* dOs = tQs + BT * LD;                       // [BT][LD]
  float* tdOs = dOs + BT * LD;                      // [BT][LD]
  float* Ks = tdOs + BT * LD;                       // [2][BK][LD]
  float* tKs = Ks + 2 * BK * LD;                    // [2][BK][LD]
  float* Vs = tKs + 2 * BK * LD;                    // [2][BK][LD]
  float* tVs = Vs + 2 * BK * LD;                    // [2][BK][LD]

  const int S = a.S, H = a.H, window = a.window;
  const int nq = (S + BT - 1) / BT;
  // one linear grid, q tile slowest: the last q tiles (the most KV tiles)
  // start first, for every head and batch
  const int nb = gridDim.x / (nq * H);                       // batch size
  const int q_lo = (nq - 1 - (int)(blockIdx.x / (H * nb))) * BT;
  const int h = blockIdx.x % H, b = (blockIdx.x / H) % nb;
  const int kvh = h / (H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, m = 16 * warp;

  const float* kb = a.k + b * a.sk.b + kvh * a.sk.h;
  const float* tkb = a.tk + b * a.stk.b + kvh * a.stk.h;
  const float* vb = a.v + b * a.sv.b + kvh * a.sv.h;
  const float* tvb = a.tv + b * a.stv.b + kvh * a.stv.h;
  const int q_hi = min(q_lo + BT - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;
  auto stage = [&](int jt) {
    const int off = ((jt - j_lo) & 1) * BK * LD;
    stage_rows<float, D, BK>(Ks + off, kb, a.sk.s, jt * BK, S);
    stage_rows<float, D, BK>(tKs + off, tkb, a.stk.s, jt * BK, S);
    stage_rows<float, D, BK>(Vs + off, vb, a.sv.s, jt * BK, S);
    stage_rows<float, D, BK>(tVs + off, tvb, a.stv.s, jt * BK, S);
  };
  stage_rows<float, D, BT>(Qs, a.q + b * a.sq.b + h * a.sq.h, a.sq.s, q_lo,
                           S);
  stage_rows<float, D, BT>(tQs, a.tq + b * a.stq.b + h * a.stq.h, a.stq.s,
                           q_lo, S);
  stage_rows<float, D, BT>(dOs, a.dout + b * a.sdo.b + h * a.sdo.h, a.sdo.s,
                           q_lo, S);
  stage_rows<float, D, BT>(tdOs, a.tdout + b * a.stdo.b + h * a.stdo.h,
                           a.stdo.s, q_lo, S);
  stage(j_lo);
  cp_async_commit();

  // this thread's rows: g and g + 8 of the warp's 16
  const long long row_off = ((long long)b * H + h) * S;
  float lse_r[2], tl_r[2], dl_r[2], tdl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q_lo + m + g + 8 * r;
    const bool in = row < S;
    lse_r[r] = in ? a.lse[row_off + row] : 0.f;
    tl_r[r] = in ? a.tlse[row_off + row] : 0.f;
    dl_r[r] = in ? a.delta[row_off + row] : 0.f;
    tdl_r[r] = in ? a.tdelta[row_off + row] : 0.f;
  }

  float acc[ND][4];
  zero(acc);

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    if (jt < j_hi) stage(jt + 1);
    cp_async_commit();
    cp_async_wait_one();   // this step's tiles (and Q, tQ, dO, tdO) landed
    __syncthreads();
    const int off = ((jt - j_lo) & 1) * BK * LD, k_lo = jt * BK;
    const float* Kb = Ks + off;
    const float* tKb = tKs + off;

    // S0 = Q K^T, tS0 = tQ K^T + Q tK^T, dP = dO V^T, tdP = tdO V^T + dO tV^T
    float s[NK][4], ts[NK][4], dp[NK][4], tdp[NK][4];
    zero(s);
    zero(ts);
    zero(dp);
    zero(tdp);
    gemm_nt_tangent<D, NK>(s, ts, Qs, tQs, Kb, tKb, LD, m, g, t);
    gemm_nt_tangent<D, NK>(dp, tdp, dOs, tdOs, Vs + off, tVs + off, LD, m,
                           g, t);
    const bool seen = k_lo + BK - 1 <= q_lo + m
                      && (!window || q_lo + m + 15 - k_lo < window);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kpos = k_lo + 8 * j + 2 * t + (e & 1);
        pair_factors(s[j][e], ts[j][e], dp[j][e], tdp[j][e], lse_r[r],
                     tl_r[r], dl_r[r], tdl_r[r],
                     seen || visible(q_lo + m + g + 8 * r, kpos, S, window),
                     a.cap, a.scale);
      }
    // tdQ += tdS0 K + dS0 tK
    add_rn2<ND, NK>(acc, tdp, Kb, dp, tKb, LD, g, t);
    __syncthreads();   // every warp is done with this buffer: it refills
  }

  float* tdqb = a.tdq + b * a.stdq.b + h * a.stdq.h;
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q_lo + m + g + (e & 2 ? 8 : 0);
      if (row < S)
        tdqb[row * a.stdq.s + 8 * j + 2 * t + (e & 1)] = a.scale * acc[j][e];
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  // above 48 KB of shared memory a launch is refused unless allowed more
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int D>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t st) {
  const size_t bytes = fwd_smem_bytes<D>();
  cudaError_t err = allow_smem(fwd_tangent<D>, bytes);
  if (err != cudaSuccess) return err;
  const unsigned ctas = (a.S + BT - 1) / BT * a.H * B;
  fwd_tangent<D><<<ctas, TC_THREADS, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.H * a.S;
  const int per = ROW_THREADS / 32;
  row_pass<D><<<(unsigned)((rows + per - 1) / per), ROW_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t kv_bytes = dkdv_smem_bytes<D>(), q_bytes = dq_smem_bytes<D>();
  if ((err = allow_smem(bwd_tangent_dkdv<D>, kv_bytes)) != cudaSuccess ||
      (err = allow_smem(bwd_tangent_dq<D>, q_bytes)) != cudaSuccess)
    return err;
  const unsigned tiles = (a.S + BT - 1) / BT;
  bwd_tangent_dkdv<D><<<tiles * a.KV * a.B, TC_THREADS, kv_bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_tangent_dq<D><<<tiles * a.H * a.B, TC_THREADS, q_bytes, st>>>(a);
  return cudaGetLastError();
}

Str str(const long long* s, int t) {
  return Str{s[3 * t], s[3 * t + 1], s[3 * t + 2]};
}

}  // namespace

extern "C" {

// q, o, tq, tout: [B, H, S, D]; k, v, tk, tv: [B, KV, S, D], float32,
// addressed through `strides` (24 int64: batch, head and sequence strides
// of q, k, v, o, tq, tk, tv, tout, in elements; the head dimension is
// contiguous, and every row of q, k, v, tq, tk, tv starts on 16 bytes).
// o and lse: the forward's output and its float32 log-sum-exp [B, H, S];
// tlse: float32 [B, H, S] out (both contiguous).  Returns the launch's
// cudaGetLastError().
int repro_flash_attention_jvp(const void* q, const void* k, const void* v,
                              const void* o, const void* lse, const void* tq,
                              const void* tk, const void* tv, void* tout,
                              void* tlse, int B, int H, int KV, int S, int D,
                              int window, float cap,
                              const long long* strides, void* stream) {
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.lse = static_cast<const float*>(lse);
  a.tq = static_cast<const float*>(tq);
  a.tk = static_cast<const float*>(tk);
  a.tv = static_cast<const float*>(tv);
  a.tout = static_cast<float*>(tout);
  a.tlse = static_cast<float*>(tlse);
  Str* dst[8] = {&a.sq, &a.sk, &a.sv, &a.so, &a.stq, &a.stk, &a.stv, &a.sto};
  for (int t = 0; t < 8; ++t) *dst[t] = str(strides, t);
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.window = window;
  a.cap = cap;
  a.scale = 1.f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = D == 32    ? launch_fwd<32>(a, B, st)
                    : D == 64  ? launch_fwd<64>(a, B, st)
                    : D == 128 ? launch_fwd<128>(a, B, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}

// q, out, dout, tq, tout, tdout, tdq: [B, H, S, D]; k, v, tk, tv, tdk,
// tdv: [B, KV, S, D], float32, addressed through `strides` (39 int64: the
// batch, head and sequence strides of q, k, v, out, dout, tq, tk, tv, tout,
// tdout, tdq, tdk, tdv in that order; the head dimension is contiguous, and
// every row of q, k, v, dout, tq, tk, tv, tdout starts on 16 bytes).
// lse, tlse: float32 [B, H, S]; delta, tdelta: float32 scratch [B, H, S]
// (all contiguous).  Writes tdq, tdk, tdv.  Returns the last launch's
// cudaGetLastError() (0 on success).
int repro_flash_attention_backward_jvp(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, const void* tq, const void* tk,
    const void* tv, const void* tout, const void* tdout, const void* tlse,
    void* delta, void* tdelta, void* tdq, void* tdk, void* tdv, int B, int H,
    int KV, int S, int D, int window, float cap, const long long* strides,
    void* stream) {
  BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(out);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.tq = static_cast<const float*>(tq);
  a.tk = static_cast<const float*>(tk);
  a.tv = static_cast<const float*>(tv);
  a.to = static_cast<const float*>(tout);
  a.tdout = static_cast<const float*>(tdout);
  a.tlse = static_cast<const float*>(tlse);
  a.delta = static_cast<float*>(delta);
  a.tdelta = static_cast<float*>(tdelta);
  a.tdq = static_cast<float*>(tdq);
  a.tdk = static_cast<float*>(tdk);
  a.tdv = static_cast<float*>(tdv);
  Str* dst[13] = {&a.sq,  &a.sk,  &a.sv,   &a.so,   &a.sdo,  &a.stq, &a.stk,
                  &a.stv, &a.sto, &a.stdo, &a.stdq, &a.stdk, &a.stdv};
  for (int t = 0; t < 13; ++t) *dst[t] = str(strides, t);
  a.B = B;
  a.H = H;
  a.KV = KV;
  a.S = S;
  a.window = window;
  a.cap = cap;
  a.scale = 1.f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = D == 32    ? launch_bwd<32>(a, st)
                    : D == 64  ? launch_bwd<64>(a, st)
                    : D == 128 ? launch_bwd<128>(a, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
