// Causal GQA flash attention for Hopper (sm_90a), float32 arithmetic:
// the forward kernel and, below it, the backward kernels.
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
// Design (first version: simple and right).  One block of 256 threads per
// (q tile of 64 rows, head, batch); a loop over the KV tiles of 64 keys from
// the first one the window lets in to the diagonal one takes the place of
// the Pallas grid's sequential fourth axis.  Q, K, V and the score tile are
// staged in shared memory as float32 (inputs are float32 or bfloat16); the
// running max m and sum l live in shared memory, the accumulator in
// registers (a 4 x D/16 micro-tile per thread).  The last q tile may be
// ragged: rows and keys past S are zero-filled and never stored, so any
// sequence length is taken.  Tiles are visited heaviest first (the q tiles
// near the end of the sequence have the most live KV tiles).
//
// What bounds it on this card: at the serving shape (B=8, H=32, S=1024,
// D=64) the causal work is 4*B*H*S^2*D/2 = 3.4e10 float32 operations against
// 0.15 GB of inputs and output, so the floor is the operations: 0.51 ms at
// 67 TFLOP/s (float32 outside the tensor cores) against 0.045 ms for the
// bytes.  This version runs on the CUDA cores from shared memory, and each
// multiply-add reads one operand from shared memory (a 4 x 4 register tile
// per thread, 8 loads per 16 FMAs), so shared-memory bandwidth, not the FMA
// rate, is its limit.  The tensor cores (TF32 or bf16 wgmma), TMA loads and
// warp specialisation are the later steps.
//
// The forward optionally writes each row's log-sum-exp m + log(l) (float32
// [B, H, S]) for the backward; given a null pointer it writes nothing, so
// the serving path's work is unchanged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int THREADS = 256;   // a 16 x 16 grid of threads
constexpr int PS = BK + 1;     // padded row stride of the score tile
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

template <int D>
constexpr size_t smem_floats() {
  // Q and K padded to D + 1 (conflict-free column reads), V, scores, and
  // three per-row arrays (corr, m, l).
  return 2 * BQ * (D + 1) + BK * D + BQ * PS + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int H, int KV, int S, int window,
             float cap, float scale, Strides st) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int RD = D / 16;          // accumulator columns per thread
  float* Qs = smem;                   // [BQ][DP]
  float* Ks = Qs + BQ * DP;           // [BK][DP]
  float* Vs = Ks + BK * DP;           // [BK][D]
  float* Ps = Vs + BK * D;            // [BQ][PS]
  float* corr_s = Ps + BQ * PS;       // [BQ]
  float* m_s = corr_s + BQ;           // [BQ]
  float* l_s = m_s + BQ;              // [BQ]

  const int nq = (S + BQ - 1) / BQ;
  const int q_lo = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];
  T* ob = o + b * st.o[0] + h * st.o[1];

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = q_lo + r;
    Qs[r * DP + c] = row < S ? to_f32(qb[row * st.q[2] + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  float acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  // Live KV tiles: from the one holding the first key that row q_lo may
  // see (q_lo - window + 1) to the one holding the last row's own key.
  const int q_hi = min(q_lo + BQ - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k_lo = jt * BK;
    __syncthreads();   // the previous tile's readers of Ks, Vs, Ps are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, c = idx % D, key = k_lo + r;
      const bool in = key < S;
      Ks[r * DP + c] = in ? to_f32(kb[key * st.k[2] + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[key * st.v[2] + c]) : 0.f;
    }
    __syncthreads();

    // Scores: this thread's rows ty + 16 i and columns tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = s[i][j] * scale;
        if (cap != 0.f) x = cap * tanhf(x / cap);
        const int qpos = q_lo + r, kpos = k_lo + c;
        bool keep = qpos >= kpos;
        if (window) keep = keep && (qpos - kpos) < window;
        Ps[r * PS + c] = keep ? x : NEG;
      }
    }
    __syncthreads();

    // Online softmax: each warp takes 8 rows, each lane two columns.
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const float a = Ps[r * PS + lane], c = Ps[r * PS + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      Ps[r * PS + lane] = pa;
      Ps[r * PS + lane + 32] = pc;
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = corr_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RD; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int j = 0; j < RD; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();   // l_s holds every row's final sum

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q_lo + r;
    if (row >= S) continue;
    float l = l_s[r];
    if (l == 0.f) l = 1.f;
#pragma unroll
    for (int j = 0; j < RD; ++j)
      store(&ob[row * st.o[2] + tx + 16 * j], acc[i][j] / l);
  }
  if (lse != nullptr && tid < BQ && q_lo + tid < S) {
    const float l = l_s[tid] == 0.f ? 1.f : l_s[tid];
    lse[((long long)b * H + h) * S + q_lo + tid] = m_s[tid] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int KV, int S, int window,
                   float cap, const Strides& st, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  auto kernel = flash_kernel<T, D>;
  // Above 48 KB of shared memory a launch is refused unless the kernel is
  // allowed more; D = 64 takes 67 KB, D = 128 116 KB.
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KV, S, window,
      cap, scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v,
                     void* o, float* lse, int B, int H, int KV, int S,
                     int window, float cap, const Strides& st,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, KV, S, window, cap, st,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, KV, S, window, cap, st,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, KV, S, window, cap, st,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// Backward (no Pallas counterpart: the reference differentiates attention
// through XLA).  FA2-style: the probabilities are recomputed from the
// forward's log-sum-exp, P = exp(x - lse) with masked entries exactly 0, in
// float32 on the CUDA cores from shared memory:
//   Delta_i = rowsum(dO o O),  dV = P^T dO,  dP = dO V^T,
//   dS = P o (dP - Delta),  with a soft-cap dS *= 1 - tanh^2(s_raw / cap),
//   dQ = dS K * scale,  dK = dS^T Q * scale.
// Three kernels: Delta (one warp a row); dK and dV, one CTA per (KV tile,
// KV head, batch) that loops over the group's H / KV query heads and the q
// tiles that see its keys, so the GQA sum over the group stays in registers
// and no float atomics are used (runs repeat bit for bit, and remat's
// recomputation sees the same numbers); dQ, one CTA per (q tile, head,
// batch) over the KV tiles the forward visits.  The scores are recomputed
// with the forward's own loop, so they equal the forward's bit for bit.
//
// What bounds it: operations.  The five causal products (QK^T, dV, dP, dQ,
// dK) are 5 * 2*B*H*S^2*D/2 = 8.6e10 float32 operations at B=8, H=32,
// S=1024, D=64, 1.28 ms at 67 TFLOP/s; this version computes seven (the
// score and dP tiles in both kernels) on the CUDA cores, limited, like the
// forward, by shared-memory reads.
// ---------------------------------------------------------------------------

struct BwdStrides {            // in elements; batch, head, sequence
  long long q[3], k[3], v[3], o[3], dout[3], dq[3], dk[3], dv[3];
};

// One score tile s[i][j] = Q[ty + 16 i] . K[tx + 16 j], as the forward
// sums it.
template <int D>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks,
                                           int ty, int tx, float s[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float qv[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
  }
}

// P and, where the scores are soft-capped, 1 - tanh^2 (else 1), from the
// raw score tile; masked entries (causal, window, past S) get P = 0.
__device__ __forceinline__ void probabilities(
    float s[4][4], float dcap[4][4], const float* lse_s, int ty, int tx,
    int q_lo, int k_lo, int S, int window, float cap, float scale) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      float x = s[i][j] * scale;
      dcap[i][j] = 1.f;
      if (cap != 0.f) {
        const float t = tanhf(x / cap);
        x = cap * t;
        dcap[i][j] = 1.f - t * t;
      }
      const int qpos = q_lo + r, kpos = k_lo + c;
      bool keep = qpos >= kpos && qpos < S && kpos < S;
      if (window) keep = keep && (qpos - kpos) < window;
      s[i][j] = keep ? expf(x - lse_s[r]) : 0.f;
    }
  }
}

// dP tile: dp[i][j] = dO[ty + 16 i] . V[tx + 16 j].
template <int D>
__device__ __forceinline__ void dp_tile(const float* dOs, const float* Vs,
                                        int ty, int tx, float dp[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dp[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float ov[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ov[i] = dOs[(ty + 16 * i) * DP + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) vv[j] = Vs[(tx + 16 * j) * DP + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
  }
}

// BQ x D rows of a [.., S, D] operand into padded shared memory (zeros past
// S).
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long row_stride, int lo,
                                          int S, int tid) {
  constexpr int DP = D + 1;
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, c = idx % D, row = lo + r;
    dst[r * DP + c] = row < S ? to_f32(src[row * row_stride + c]) : 0.f;
  }
}

template <int D>
constexpr size_t bwd_smem_floats() {
  // four padded [64][D + 1] tiles, the P / dS tile, lse and Delta rows
  return 4 * BQ * (D + 1) + BQ * PS + 2 * BQ;
}

// Delta[b, h, s] = sum_d dO * O, one warp a row.
template <typename T, int D>
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
  for (int d = lane; d < D; d += 32) sum += to_f32(orow[d]) * to_f32(grow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) delta[w] = sum;
}

// dK and dV of one KV tile of one KV head, summed over the group's heads.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int KV, int S, int window,
                      float cap, float scale, BwdStrides st) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int RD = D / 16;
  float* Ks = smem;                   // [BK][DP]
  float* Vs = Ks + BK * DP;           // [BK][DP]
  float* Qs = Vs + BK * DP;           // [BQ][DP]
  float* dOs = Qs + BQ * DP;          // [BQ][DP]
  float* Ps = dOs + BQ * DP;          // [BQ][PS]: P, then dS
  float* lse_s = Ps + BQ * PS;        // [BQ]
  float* dl_s = lse_s + BQ;           // [BQ]

  const int k_lo = blockIdx.x * BK;   // tile 0, which every q tile sees, first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_rows<T, D>(Ks, k + b * st.k[0] + kvh * st.k[1], st.k[2], k_lo, S, tid);
  load_rows<T, D>(Vs, v + b * st.v[0] + kvh * st.v[1], st.v[2], k_lo, S, tid);

  float dk_acc[4][RD], dv_acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // q tiles that see a key of this tile: from the one holding row k_lo to
  // the one holding the last row the window lets see the tile's last key.
  const int nq = (S + BQ - 1) / BQ;
  const int k_hi = min(k_lo + BK - 1, S - 1);
  const int i_lo = k_lo / BQ;
  const int i_hi = window ? min(nq - 1, (k_hi + window - 1) / BQ) : nq - 1;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const T* qb = q + b * st.q[0] + h * st.q[1];
    const T* gb = dout + b * st.dout[0] + h * st.dout[1];
    const float* lse_b = lse + ((long long)b * H + h) * S;
    const float* dl_b = delta + ((long long)b * H + h) * S;
    for (int it = i_lo; it <= i_hi; ++it) {
      const int q_lo = it * BQ;
      __syncthreads();   // the previous tile's readers are done
      load_rows<T, D>(Qs, qb, st.q[2], q_lo, S, tid);
      load_rows<T, D>(dOs, gb, st.dout[2], q_lo, S, tid);
      if (tid < BQ) {
        const int row = q_lo + tid;
        lse_s[tid] = row < S ? lse_b[row] : 0.f;
        dl_s[tid] = row < S ? dl_b[row] : 0.f;
      }
      __syncthreads();

      float p[4][4], dcap[4][4], dp[4][4];
      score_tile<D>(Qs, Ks, ty, tx, p);
      probabilities(p, dcap, lse_s, ty, tx, q_lo, k_lo, S, window, cap,
                    scale);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(ty + 16 * i) * PS + tx + 16 * j] = p[i][j];
      __syncthreads();

      // dV[key ty + 16 i][tx + 16 j] += sum_r P[r][key] dO[r][.]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[4], gv[RD];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = Ps[r * PS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RD; ++j) gv[j] = dOs[r * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RD; ++j)
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
      }
      dp_tile<D>(dOs, Vs, ty, tx, dp);
      __syncthreads();   // every reader of P is done: P becomes dS
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i;
          Ps[r * PS + tx + 16 * j] =
              p[i][j] * (dp[i][j] - dl_s[r]) * dcap[i][j];
        }
      __syncthreads();

      // dK[key ty + 16 i][tx + 16 j] += sum_r dS[r][key] Q[r][.]
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float sv[4], qv[RD];
#pragma unroll
        for (int i = 0; i < 4; ++i) sv[i] = Ps[r * PS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < RD; ++j) qv[j] = Qs[r * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < RD; ++j)
            dk_acc[i][j] = fmaf(sv[i], qv[j], dk_acc[i][j]);
      }
    }
  }

  T* dkb = dk + b * st.dk[0] + kvh * st.dk[1];
  T* dvb = dv + b * st.dv[0] + kvh * st.dv[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k_lo + ty + 16 * i;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j) {
      store(&dkb[key * st.dk[2] + tx + 16 * j], dk_acc[i][j] * scale);
      store(&dvb[key * st.dv[2] + tx + 16 * j], dv_acc[i][j]);
    }
  }
}

// dQ of one q tile of one head, over the KV tiles the forward visits.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int KV, int S, int window, float cap, float scale,
                    BwdStrides st) {
  extern __shared__ float smem[];
  constexpr int DP = D + 1;
  constexpr int RD = D / 16;
  float* Qs = smem;                   // [BQ][DP]
  float* dOs = Qs + BQ * DP;          // [BQ][DP]
  float* Ks = dOs + BQ * DP;          // [BK][DP]
  float* Vs = Ks + BK * DP;           // [BK][DP]
  float* Ps = Vs + BK * DP;           // [BQ][PS]: dS
  float* lse_s = Ps + BQ * PS;        // [BQ]
  float* dl_s = lse_s + BQ;           // [BQ]

  const int nq = (S + BQ - 1) / BQ;
  const int q_lo = (nq - 1 - (int)blockIdx.x) * BQ;   // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  load_rows<T, D>(Qs, q + b * st.q[0] + h * st.q[1], st.q[2], q_lo, S, tid);
  load_rows<T, D>(dOs, dout + b * st.dout[0] + h * st.dout[1], st.dout[2],
                  q_lo, S, tid);
  if (tid < BQ) {
    const int row = q_lo + tid;
    const long long off = ((long long)b * H + h) * S + row;
    lse_s[tid] = row < S ? lse[off] : 0.f;
    dl_s[tid] = row < S ? delta[off] : 0.f;
  }
  const T* kb = k + b * st.k[0] + kvh * st.k[1];
  const T* vb = v + b * st.v[0] + kvh * st.v[1];

  float acc[4][RD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RD; ++j) acc[i][j] = 0.f;

  const int q_hi = min(q_lo + BQ - 1, S - 1);
  const int j_lo = window ? max(0, q_lo - window + 1) / BK : 0;
  const int j_hi = q_hi / BK;
  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k_lo = jt * BK;
    __syncthreads();   // the previous tile's readers are done
    load_rows<T, D>(Ks, kb, st.k[2], k_lo, S, tid);
    load_rows<T, D>(Vs, vb, st.v[2], k_lo, S, tid);
    __syncthreads();

    float p[4][4], dcap[4][4], dp[4][4];
    score_tile<D>(Qs, Ks, ty, tx, p);
    probabilities(p, dcap, lse_s, ty, tx, q_lo, k_lo, S, window, cap, scale);
    dp_tile<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i;
        Ps[r * PS + tx + 16 * j] = p[i][j] * (dp[i][j] - dl_s[r]) * dcap[i][j];
      }
    __syncthreads();

    // dQ[ty + 16 i][tx + 16 j] += sum_c dS[.][c] K[c][.]
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[4], kv[RD];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ps[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < RD; ++j) kv[j] = Ks[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RD; ++j) acc[i][j] = fmaf(sv[i], kv[j], acc[i][j]);
    }
  }

  T* dqb = dq + b * st.dq[0] + h * st.dq[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q_lo + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < RD; ++j)
      store(&dqb[row * st.dq[2] + tx + 16 * j], acc[i][j] * scale);
  }
}

template <typename T, int D>
cudaError_t launch_backward(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse,
                            float* delta, void* dq, void* dk, void* dv,
                            int B, int H, int KV, int S, int window,
                            float cap, const BwdStrides& st,
                            cudaStream_t stream) {
  const long long rows = (long long)B * H * S;
  const unsigned delta_blocks =
      static_cast<unsigned>((rows * 32 + THREADS - 1) / THREADS);
  flash_bwd_delta_kernel<T, D><<<delta_blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, H, S,
      rows, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t bytes = bwd_smem_floats<D>() * sizeof(float);
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dqk = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  const int ntiles = (S + BQ - 1) / BQ;
  dkdv<<<dim3(ntiles, KV, B), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, KV, S, window, cap, scale,
      st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3(ntiles, H, B), THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, KV, S, window, cap, scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_backward(int D, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int B, int H, int KV, int S,
                              int window, float cap, const BwdStrides& st,
                              cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_backward<T, 32>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, H, KV, S, window, cap, st, stream);
    case 64:
      return launch_backward<T, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    B, H, KV, S, window, cap, st, stream);
    case 128:
      return launch_backward<T, 128>(q, k, v, o, dout, lse, delta, dq, dk,
                                     dv, B, H, KV, S, window, cap, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: [B, H, S, D]; k, v: [B, KV, S, D], addressed through `strides`
// (12 int64: batch, head and sequence strides of q, k, v, o, in elements;
// the head dimension is contiguous).  dtype 0 = float32, 1 = bfloat16.
// lse: null, or float32 [B, H, S] (contiguous) for each row's log-sum-exp.
// Returns the launch's cudaGetLastError() (0 on success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* o, void* lse, int dtype, int B, int H, int KV,
                          int S, int D, int window, float cap,
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
          ? dispatch<float>(D, q, k, v, o, l, B, H, KV, S, window, cap, st, s)
          : dtype == 1 ? dispatch<__nv_bfloat16>(D, q, k, v, o, l, B, H, KV,
                                                 S, window, cap, st, s)
                       : cudaErrorInvalidValue;
  return (int)err;
}

// q, o, dout, dq: [B, H, S, D]; k, v, dk, dv: [B, KV, S, D], addressed
// through `strides` (24 int64: batch, head and sequence strides of q, k, v,
// o, dout, dq, dk, dv, in elements; the head dimension is contiguous).
// lse: the forward's float32 [B, H, S]; delta: float32 scratch [B, H, S].
// dtype 0 = float32, 1 = bfloat16 (every operand; lse and delta float32).
// Returns the last launch's cudaGetLastError() (0 on success).
int repro_flash_attention_backward(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int dtype, int B, int H, int KV, int S,
                                   int D, int window, float cap,
                                   const long long* strides, void* stream) {
  BwdStrides st;
  long long* dst[8] = {st.q, st.k, st.v, st.o, st.dout, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaError_t err =
      dtype == 0 ? dispatch_backward<float>(D, q, k, v, o, dout, l, dl, dq,
                                            dk, dv, B, H, KV, S, window, cap,
                                            st, s)
      : dtype == 1 ? dispatch_backward<__nv_bfloat16>(
                         D, q, k, v, o, dout, l, dl, dq, dk, dv, B, H, KV, S,
                         window, cap, st, s)
                   : cudaErrorInvalidValue;
  return (int)err;
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
