// Tangents of causal GQA flash attention for Hopper (sm_90a), float32 on
// the CUDA cores: the forward's tangent and the backward's tangent, which
// carry a Hessian-vector product (forward over reverse) through attention.
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
//      = sum_j (P tS) V + P tV - t_lse (P V),
// so one pass over the live KV tiles with the forward's lse (no online
// rescaling) sums A = (P tS) V + P tV, C = P V and t_lse, and writes
// tO = A - t_lse C.
// Backward tangent (D = rowsum(dO O), dS = P (dO V^T - D), dS0 = c' dS;
// dQ = scale dS0 K, dK = scale dS0^T Q, dV = P^T dO):
//   tdP = tdO V^T + dO tV^T, tD = rowsum(tdO O + dO tO),
//   tdS = tP (dP - D) + P (tdP - tD),
//   tdS0 = c' tdS + dS c'' tS0, c'' = -2 tanh(S0 / cap) c' / cap,
//   tdQ = scale (tdS0 K + dS0 tK), tdK = scale (tdS0^T Q + dS0^T tQ),
//   tdV = tP^T dO + P^T tdO,
// split as the backward is split: a row pass for D and tD, a dK/dV kernel
// over key tiles (looping over the query heads of its KV group and the
// query tiles that see it: GQA groups summed without atomics) and a dQ
// kernel over query tiles.  No float atomics: two runs give the same bits.
//
// Design: simple and right first.  A CTA of 128 threads owns a 32-row tile
// (query rows, or keys in the dK/dV kernel) and loops over the other
// side's 32-row tiles; every operand tile is staged in shared memory with
// rows padded by one float (conflict-free across rows).  Per pair of
// tiles: lane j of each warp takes key j against eight query rows (the
// dot products over D with the query side's values broadcast), writes the
// pair's P-like factors to shared memory, and then each thread sums its
// (row, column) outputs over the 32 pairs.  Float32 FMAs throughout.
//
// What bounds these kernels on this card: operations.  At the training
// shape (B=8, H=32, KV=4, S=1024, D=64) the forward tangent needs 10 D
// flops a live (query, key) pair (S0, tS0's two products, tO's two), the
// backward tangent 24 D (S0, tS0, dP, tdP and two products for each of
// tdQ, tdK, tdV), over B H S (S + 1) / 2 pairs: 8.6e10 and 2.1e11 flops,
// 0.52 and 1.25 ms as 3xTF32 on the tensor cores (three TF32 operations
// a float32 one at 495 TFLOP/s, the bound of flash_attention.cu's float32
// kernels; 1.28 and 3.08 ms at the 67 TFLOP/s of float32 on the CUDA
// cores, this file's route), against 0.24 and 0.52 GB of inputs and
// outputs.  These kernels do 12 D and 36 D
// (C = P V beside tO; the dQ kernel recomputes the pair's four dot
// products), and the score phase reads every operand from shared memory
// one float at a time (4.5 loads an FMA pair), so the loads bound it well
// before the FMA rate: 9.89 and 35.85 ms (chip_smoke.flash_jvp_timing;
// NVIDIA H100 80GB HBM3, 700 W).  Float4 shared loads, then 3xTF32
// mma.sync as in flash_attention.cu, are the next steps.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 128;      // threads a CTA
constexpr int BR = 32;       // rows a tile (query or key), one per lane
constexpr int NW = NT / 32;  // warps a CTA
constexpr int RPW = BR / NW; // query rows a warp scores: eight
constexpr int ROW_THREADS = 256;  // the D / tD row pass: eight rows a block

struct T4 {                  // batch, head, sequence strides (elements)
  long long b, h, s;
};

__device__ __forceinline__ long long at(const T4& t, int b, int h, int i) {
  return b * t.b + h * t.h + (long long)i * t.s;
}

// R rows of a [.., S, D] operand (row lo on) into a [R][D + 1] tile,
// zeros past S.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      const T4& st, int b, int h, int lo,
                                      int S) {
  for (int idx = threadIdx.x; idx < BR * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int i = lo + r;
    dst[r * (D + 1) + d] = i < S ? src[at(st, b, h, i) + d] : 0.f;
  }
}

// BR floats of a [B, H, S] row vector (contiguous), zeros past S.
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          int b, int h, int H, int lo,
                                          int S) {
  for (int r = threadIdx.x; r < BR; r += NT) {
    const int i = lo + r;
    dst[r] = i < S ? src[((long long)b * H + h) * S + i] : 0.f;
  }
}

__device__ __forceinline__ bool live(int i, int j, int S, int window) {
  return i < S && j < S && j <= i && (window == 0 || i - j < window);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// First and last KV tile a query tile [q0, q0 + BR) sees.
__device__ __forceinline__ void kv_tiles(int q0, int S, int window,
                                         int* lo, int* hi) {
  const int q1 = min(q0 + BR, S) - 1;
  const int jlo = window > 0 ? max(0, q0 - window + 1) : 0;
  *lo = jlo / BR;
  *hi = q1 / BR;
}

// ---------------------------------------------------------------------------
// Forward tangent: one CTA a (query tile, head, batch row).
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float *q, *k, *v, *lse, *tq, *tk, *tv;
  float *tout, *tlse;
  T4 sq, sk, sv, stq, stk, stv, sto;
  int H, KV, S, window;
  float cap, scale;
};

template <int D>
__global__ void __launch_bounds__(NT) fwd_tangent(FwdArgs a) {
  extern __shared__ float sm[];
  constexpr int LD = D + 1, LP = BR + 1;
  float* q_s = sm;
  float* tq_s = q_s + BR * LD;
  float* k_s = tq_s + BR * LD;
  float* tk_s = k_s + BR * LD;
  float* v_s = tk_s + BR * LD;
  float* tv_s = v_s + BR * LD;
  float* p_s = tv_s + BR * LD;        // P
  float* pt_s = p_s + BR * LP;        // P tS
  float* lse_s = pt_s + BR * LP;
  float* tlse_s = lse_s + BR;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KV);
  const int q0 = qt * BR, S = a.S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage<D>(q_s, a.q, a.sq, b, h, q0, S);
  stage<D>(tq_s, a.tq, a.stq, b, h, q0, S);
  stage_row(lse_s, a.lse, b, h, a.H, q0, S);
  for (int r = threadIdx.x; r < BR; r += NT) tlse_s[r] = 0.f;

  // outputs: column c, rows g + RG e
  constexpr int RG = NT / D > 0 ? NT / D : 1;
  constexpr int RPT = BR / RG;
  const int c = threadIdx.x % D, g = threadIdx.x / D;
  float acc_a[RPT], acc_c[RPT];
#pragma unroll
  for (int e = 0; e < RPT; ++e) acc_a[e] = acc_c[e] = 0.f;

  int kt_lo, kt_hi;
  kv_tiles(q0, S, a.window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();
    stage<D>(k_s, a.k, a.sk, b, kh, k0, S);
    stage<D>(tk_s, a.tk, a.stk, b, kh, k0, S);
    stage<D>(v_s, a.v, a.sv, b, kh, k0, S);
    stage<D>(tv_s, a.tv, a.stv, b, kh, k0, S);
    __syncthreads();
    // scores: lane = key, eight rows a warp
    float s[RPW], t[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = t[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = k_s[lane * LD + d], tkd = tk_s[lane * LD + d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const int i = warp + NW * r;
        const float qd = q_s[i * LD + d], tqd = tq_s[i * LD + d];
        s[r] = fmaf(qd, kd, s[r]);
        t[r] = fmaf(tqd, kd, fmaf(qd, tkd, t[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp + NW * r;
      float p = 0.f, pts = 0.f;
      if (live(q0 + i, k0 + lane, S, a.window)) {
        const float x = s[r] * a.scale;
        float sc = x, c1 = 1.f;
        if (a.cap != 0.f) {
          const float th = tanhf(x / a.cap);
          sc = a.cap * th;
          c1 = 1.f - th * th;
        }
        p = expf(sc - lse_s[i]);
        pts = p * (c1 * (t[r] * a.scale));
      }
      p_s[i * LP + lane] = p;
      pt_s[i * LP + lane] = pts;
      const float row = warp_sum(pts);
      if (lane == 0) tlse_s[i] += row;
    }
    __syncthreads();
    for (int j = 0; j < BR; ++j) {
      const float vj = v_s[j * LD + c], tvj = tv_s[j * LD + c];
#pragma unroll
      for (int e = 0; e < RPT; ++e) {
        const int i = g + RG * e;
        const float p = p_s[i * LP + j], pts = pt_s[i * LP + j];
        acc_a[e] = fmaf(pts, vj, fmaf(p, tvj, acc_a[e]));
        acc_c[e] = fmaf(p, vj, acc_c[e]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const int i = g + RG * e;
    if (q0 + i < S)
      a.tout[at(a.sto, b, h, q0 + i) + c] = acc_a[e] - tlse_s[i] * acc_c[e];
  }
  for (int r = threadIdx.x; r < BR; r += NT)
    if (q0 + r < S) a.tlse[((long long)b * a.H + h) * S + q0 + r] = tlse_s[r];
}

// ---------------------------------------------------------------------------
// Backward tangent.
// ---------------------------------------------------------------------------

struct BwdArgs {
  const float *q, *k, *v, *o, *dout, *lse, *tq, *tk, *tv, *to, *tdout,
      *tlse;
  float *delta, *tdelta, *tdq, *tdk, *tdv;
  T4 sq, sk, sv, so, sdo, stq, stk, stv, sto, stdo, stdq, stdk, stdv;
  int B, H, KV, S, window;
  float cap, scale;
};

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
  s = warp_sum(s);
  ts = warp_sum(ts);
  if (lane == 0) {
    a.delta[row] = s;
    a.tdelta[row] = ts;
  }
}

// The pair factors of a (query tile, key tile) block: lane = key j, eight
// query rows a warp.  Writes P, tP, dS0 and tdS0 (any of them may be
// skipped with a null pointer) as [BR][BR + 1] tiles.
template <int D>
__device__ __forceinline__ void bwd_pairs(
    const BwdArgs& a, const float* q_s, const float* tq_s, const float* do_s,
    const float* tdo_s, const float* k_s, const float* tk_s,
    const float* v_s, const float* tv_s, const float* rows_s, int q0,
    int k0, float* p_s, float* tp_s, float* ds0_s, float* tds0_s) {
  constexpr int LD = D + 1, LP = BR + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float *lse_s = rows_s, *tlse_s = rows_s + BR,
              *del_s = rows_s + 2 * BR, *tdel_s = rows_s + 3 * BR;
  float s[RPW], t[RPW], dp[RPW], tdp[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) s[r] = t[r] = dp[r] = tdp[r] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float kd = k_s[lane * LD + d], tkd = tk_s[lane * LD + d];
    const float vd = v_s[lane * LD + d], tvd = tv_s[lane * LD + d];
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int i = warp + NW * r;
      const float qd = q_s[i * LD + d], tqd = tq_s[i * LD + d];
      const float dod = do_s[i * LD + d], tdod = tdo_s[i * LD + d];
      s[r] = fmaf(qd, kd, s[r]);
      t[r] = fmaf(tqd, kd, fmaf(qd, tkd, t[r]));
      dp[r] = fmaf(dod, vd, dp[r]);
      tdp[r] = fmaf(tdod, vd, fmaf(dod, tvd, tdp[r]));
    }
  }
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int i = warp + NW * r;
    float p = 0.f, tp = 0.f, ds0 = 0.f, tds0 = 0.f;
    if (live(q0 + i, k0 + lane, a.S, a.window)) {
      const float x = s[r] * a.scale, ts0 = t[r] * a.scale;
      float sc = x, c1 = 1.f, c2 = 0.f;
      if (a.cap != 0.f) {
        const float th = tanhf(x / a.cap);
        sc = a.cap * th;
        c1 = 1.f - th * th;
        c2 = -2.f * th * c1 / a.cap;
      }
      p = expf(sc - lse_s[i]);
      tp = p * (c1 * ts0 - tlse_s[i]);
      const float dpd = dp[r] - del_s[i];
      const float ds = p * dpd;
      const float tds = tp * dpd + p * (tdp[r] - tdel_s[i]);
      ds0 = c1 * ds;
      tds0 = c1 * tds + ds * c2 * ts0;
    }
    if (p_s) p_s[i * LP + lane] = p;
    if (tp_s) tp_s[i * LP + lane] = tp;
    ds0_s[i * LP + lane] = ds0;
    tds0_s[i * LP + lane] = tds0;
  }
}

// Stage a query tile of head h: q, tq, dO, tdO and the row scalars lse,
// t_lse, D, tD.
template <int D>
__device__ __forceinline__ void stage_queries(const BwdArgs& a, float* q_s,
                                              float* tq_s, float* do_s,
                                              float* tdo_s, float* rows_s,
                                              int b, int h, int q0) {
  stage<D>(q_s, a.q, a.sq, b, h, q0, a.S);
  stage<D>(tq_s, a.tq, a.stq, b, h, q0, a.S);
  stage<D>(do_s, a.dout, a.sdo, b, h, q0, a.S);
  stage<D>(tdo_s, a.tdout, a.stdo, b, h, q0, a.S);
  stage_row(rows_s, a.lse, b, h, a.H, q0, a.S);
  stage_row(rows_s + BR, a.tlse, b, h, a.H, q0, a.S);
  stage_row(rows_s + 2 * BR, a.delta, b, h, a.H, q0, a.S);
  stage_row(rows_s + 3 * BR, a.tdelta, b, h, a.H, q0, a.S);
}

template <int D>
__device__ __forceinline__ void stage_keys(const BwdArgs& a, float* k_s,
                                           float* tk_s, float* v_s,
                                           float* tv_s, int b, int kh,
                                           int k0) {
  stage<D>(k_s, a.k, a.sk, b, kh, k0, a.S);
  stage<D>(tk_s, a.tk, a.stk, b, kh, k0, a.S);
  stage<D>(v_s, a.v, a.sv, b, kh, k0, a.S);
  stage<D>(tv_s, a.tv, a.stv, b, kh, k0, a.S);
}

template <int D>
constexpr int bwd_smem_floats() {
  return 8 * BR * (D + 1) + 4 * BR * (BR + 1) + 4 * BR;
}

// tdK and tdV: one CTA a (key tile, KV head, batch row), over the G query
// heads of its group and the query tiles that see the key tile.
template <int D>
__global__ void __launch_bounds__(NT) bwd_tangent_dkdv(BwdArgs a) {
  extern __shared__ float sm[];
  constexpr int LD = D + 1, LP = BR + 1;
  float* k_s = sm;
  float* tk_s = k_s + BR * LD;
  float* v_s = tk_s + BR * LD;
  float* tv_s = v_s + BR * LD;
  float* q_s = tv_s + BR * LD;
  float* tq_s = q_s + BR * LD;
  float* do_s = tq_s + BR * LD;
  float* tdo_s = do_s + BR * LD;
  float* p_s = tdo_s + BR * LD;
  float* tp_s = p_s + BR * LP;
  float* ds0_s = tp_s + BR * LP;
  float* tds0_s = ds0_s + BR * LP;
  float* rows_s = tds0_s + BR * LP;

  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.KV, S = a.S;
  const int k0 = kt * BR, k1 = min(k0 + BR, S) - 1;
  const int last = a.window > 0 ? min(S - 1, k1 + a.window - 1) : S - 1;
  stage_keys<D>(a, k_s, tk_s, v_s, tv_s, b, kh, k0);

  constexpr int RG = NT / D > 0 ? NT / D : 1;
  constexpr int KPT = BR / RG;
  const int c = threadIdx.x % D, g = threadIdx.x / D;
  float acc_k[KPT], acc_v[KPT];
#pragma unroll
  for (int e = 0; e < KPT; ++e) acc_k[e] = acc_v[e] = 0.f;

  for (int h = kh * G; h < kh * G + G; ++h) {
    for (int qt = k0 / BR; qt <= last / BR; ++qt) {
      const int q0 = qt * BR;
      __syncthreads();
      stage_queries<D>(a, q_s, tq_s, do_s, tdo_s, rows_s, b, h, q0);
      __syncthreads();
      bwd_pairs<D>(a, q_s, tq_s, do_s, tdo_s, k_s, tk_s, v_s, tv_s, rows_s,
                   q0, k0, p_s, tp_s, ds0_s, tds0_s);
      __syncthreads();
      for (int i = 0; i < BR; ++i) {
        const float qd = q_s[i * LD + c], tqd = tq_s[i * LD + c];
        const float dod = do_s[i * LD + c], tdod = tdo_s[i * LD + c];
#pragma unroll
        for (int e = 0; e < KPT; ++e) {
          const int j = g + RG * e;
          acc_k[e] = fmaf(tds0_s[i * LP + j], qd,
                          fmaf(ds0_s[i * LP + j], tqd, acc_k[e]));
          acc_v[e] = fmaf(tp_s[i * LP + j], dod,
                          fmaf(p_s[i * LP + j], tdod, acc_v[e]));
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < KPT; ++e) {
    const int j = g + RG * e;
    if (k0 + j < S) {
      a.tdk[at(a.stdk, b, kh, k0 + j) + c] = a.scale * acc_k[e];
      a.tdv[at(a.stdv, b, kh, k0 + j) + c] = acc_v[e];
    }
  }
}

// tdQ: one CTA a (query tile, head, batch row), over the live key tiles.
template <int D>
__global__ void __launch_bounds__(NT) bwd_tangent_dq(BwdArgs a) {
  extern __shared__ float sm[];
  constexpr int LD = D + 1, LP = BR + 1;
  float* q_s = sm;
  float* tq_s = q_s + BR * LD;
  float* do_s = tq_s + BR * LD;
  float* tdo_s = do_s + BR * LD;
  float* k_s = tdo_s + BR * LD;
  float* tk_s = k_s + BR * LD;
  float* v_s = tk_s + BR * LD;
  float* tv_s = v_s + BR * LD;
  float* ds0_s = tv_s + BR * LD;
  float* tds0_s = ds0_s + BR * LP;
  float* rows_s = tds0_s + BR * LP;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.H / a.KV), q0 = qt * BR;
  stage_queries<D>(a, q_s, tq_s, do_s, tdo_s, rows_s, b, h, q0);

  constexpr int RG = NT / D > 0 ? NT / D : 1;
  constexpr int RPT = BR / RG;
  const int c = threadIdx.x % D, g = threadIdx.x / D;
  float acc[RPT];
#pragma unroll
  for (int e = 0; e < RPT; ++e) acc[e] = 0.f;

  int kt_lo, kt_hi;
  kv_tiles(q0, a.S, a.window, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BR;
    __syncthreads();
    stage_keys<D>(a, k_s, tk_s, v_s, tv_s, b, kh, k0);
    __syncthreads();
    bwd_pairs<D>(a, q_s, tq_s, do_s, tdo_s, k_s, tk_s, v_s, tv_s, rows_s,
                 q0, k0, nullptr, nullptr, ds0_s, tds0_s);
    __syncthreads();
    for (int j = 0; j < BR; ++j) {
      const float kd = k_s[j * LD + c], tkd = tk_s[j * LD + c];
#pragma unroll
      for (int e = 0; e < RPT; ++e) {
        const int i = g + RG * e;
        acc[e] = fmaf(tds0_s[i * LP + j], kd,
                      fmaf(ds0_s[i * LP + j], tkd, acc[e]));
      }
    }
  }
#pragma unroll
  for (int e = 0; e < RPT; ++e) {
    const int i = g + RG * e;
    if (q0 + i < a.S) a.tdq[at(a.stdq, b, h, q0 + i) + c] = a.scale * acc[e];
  }
}

template <int D>
constexpr int fwd_smem_floats() {
  return 6 * BR * (D + 1) + 2 * BR * (BR + 1) + 2 * BR;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int D>
cudaError_t launch_fwd(const FwdArgs& a, int B, cudaStream_t st) {
  const int bytes = fwd_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = allow_smem(fwd_tangent<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BR - 1) / BR, a.H, B);
  fwd_tangent<D><<<grid, NT, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  const long long rows = (long long)a.B * a.H * a.S;
  const int per = ROW_THREADS / 32;
  row_pass<D><<<(unsigned)((rows + per - 1) / per), ROW_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int bytes = bwd_smem_floats<D>() * (int)sizeof(float);
  if ((err = allow_smem(bwd_tangent_dkdv<D>, bytes)) != cudaSuccess ||
      (err = allow_smem(bwd_tangent_dq<D>, bytes)) != cudaSuccess)
    return err;
  const int tiles = (a.S + BR - 1) / BR;
  bwd_tangent_dkdv<D><<<dim3(tiles, a.KV, a.B), NT, bytes, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  bwd_tangent_dq<D><<<dim3(tiles, a.H, a.B), NT, bytes, st>>>(a);
  return cudaGetLastError();
}

T4 t4(const long long* s, int t) {
  return T4{s[3 * t], s[3 * t + 1], s[3 * t + 2]};
}

}  // namespace

extern "C" {

// q, tq, tout: [B, H, S, D]; k, v, tk, tv: [B, KV, S, D], float32,
// addressed through `strides` (21 int64: batch, head and sequence strides
// of q, k, v, tq, tk, tv, tout, in elements; the head dimension is
// contiguous).  lse: the forward's float32 [B, H, S]; tlse: float32
// [B, H, S] out (both contiguous).  Returns the launch's cudaGetLastError().
int repro_flash_attention_jvp(const void* q, const void* k, const void* v,
                              const void* lse, const void* tq,
                              const void* tk, const void* tv, void* tout,
                              void* tlse, int B, int H, int KV, int S, int D,
                              int window, float cap,
                              const long long* strides, void* stream) {
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.lse = static_cast<const float*>(lse);
  a.tq = static_cast<const float*>(tq);
  a.tk = static_cast<const float*>(tk);
  a.tv = static_cast<const float*>(tv);
  a.tout = static_cast<float*>(tout);
  a.tlse = static_cast<float*>(tlse);
  a.sq = t4(strides, 0);
  a.sk = t4(strides, 1);
  a.sv = t4(strides, 2);
  a.stq = t4(strides, 3);
  a.stk = t4(strides, 4);
  a.stv = t4(strides, 5);
  a.sto = t4(strides, 6);
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
// tdout, tdq, tdk, tdv in that order; the head dimension is contiguous).
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
  T4* dst[13] = {&a.sq,  &a.sk,  &a.sv,   &a.so,   &a.sdo,  &a.stq, &a.stk,
                 &a.stv, &a.sto, &a.stdo, &a.stdq, &a.stdk, &a.stdv};
  for (int t = 0; t < 13; ++t) *dst[t] = t4(strides, t);
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
